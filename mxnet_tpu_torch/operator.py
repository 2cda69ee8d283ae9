"""User-defined operators (counterpart of ``mxnet_tpu/operator.py``; ref:
python/mxnet/operator.py CustomOp/CustomOpProp/register,
src/operator/custom/custom.cc). Two tiers, the faster first:

1. :func:`register_torch_op`: a torch function (with, optionally, its own
   backward through a ``torch.autograd.Function``) registered into the
   port's op registry, so it is ``nd.<name>``, records on the tape, and a
   hybridized block's CUDA graph captures it like any built-in op. It
   takes the place of the JAX package's ``register_jax_op``.
2. :class:`CustomOp`/:class:`CustomOpProp`/:func:`register` and
   ``nd.Custom``: host Python forward and backward over NDArrays, run
   eagerly and recorded as one node of the graph, with MXNet's semantics
   (``req`` write/add/null in :meth:`CustomOp.assign`, ``infer_shape``/
   ``infer_type``, ``need_top_grad``, auxiliary states). Inside a CUDA
   graph capture ``Custom`` raises: a host callback cannot be replayed.

The JAX package's third tier, ``as_jax_fn`` (a host op inside traced JAX
code through ``jax.pure_callback``), has no counterpart: a torch program
calls ``nd.Custom`` directly.
"""
from __future__ import annotations

import numpy as np
import torch

from . import autograd
from .base import register_op, resolve_dtype

__all__ = ["CustomOp", "CustomOpProp", "register", "get", "Custom",
           "register_torch_op"]


class CustomOp:
    """Base class for user ops (ref: python/mxnet/operator.py:CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into the NDArray ``dst`` under ``req``: ``write``
        (or ``inplace``) replaces it, ``add`` adds to it, ``null`` leaves
        it."""
        if req == "null":
            return
        from .ndarray import NDArray

        t = dst._data
        s = src._data if isinstance(src, NDArray) else torch.as_tensor(
            np.asarray(src), device=t.device)
        s = s.to(device=t.device, dtype=t.dtype)
        if req == "add":
            dst._rebind(t + s)
        else:
            dst._rebind(s.reshape(t.shape))


class CustomOpProp:
    """An op's metadata: its arguments, outputs, auxiliary states, shapes
    and types (ref: python/mxnet/operator.py:CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        t = in_type[0] if in_type else np.float32
        return in_type, [t] * len(self.list_outputs()), \
            [t] * len(self.list_auxiliary_states())

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


_CUSTOM_REGISTRY = {}


def register(op_type):
    """Decorator: register a :class:`CustomOpProp` subclass under
    ``op_type`` (ref: python/mxnet/operator.py:register)."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise TypeError("register() expects a CustomOpProp subclass")
        _CUSTOM_REGISTRY[op_type] = prop_cls
        return prop_cls

    return deco


def get(op_type):
    try:
        return _CUSTOM_REGISTRY[op_type]
    except KeyError:
        raise ValueError("custom op %r is not registered" % (op_type,))


def _build(op_type, in_shapes, in_dtypes, kwargs):
    """(prop, op, output shapes, output dtypes, aux shapes, aux dtypes)
    from the prop's ``infer_shape`` and ``infer_type``."""
    prop = get(op_type)(**kwargs)
    n_out = len(prop.list_outputs())
    n_aux = len(prop.list_auxiliary_states())
    _, out_shapes, aux_shapes = prop.infer_shape([list(s) for s in in_shapes])
    _, out_dtypes, aux_dtypes = prop.infer_type(list(in_dtypes))
    op = prop.create_operator(None, in_shapes, in_dtypes)
    return (prop, op, [tuple(s) for s in out_shapes[:n_out]],
            out_dtypes[:n_out], [tuple(s) for s in aux_shapes[:n_aux]],
            aux_dtypes[:n_aux])


def _alloc(shapes, dtypes, device):
    from .ndarray import NDArray

    return [NDArray(torch.zeros(s, dtype=resolve_dtype(d), device=device))
            for s, d in zip(shapes, dtypes)]


class _CustomNode(torch.autograd.Function):
    """One ``nd.Custom`` call in the graph: its forward runs the op's on
    NDArrays with recording paused, its backward the op's backward."""

    @staticmethod
    def forward(ctx, call, *inputs):
        from .ndarray import NDArray

        prop, op, out_shapes, out_dtypes, aux_shapes, aux_dtypes = call
        device = inputs[0].device
        in_data = [NDArray(t.detach()) for t in inputs]
        out_data = _alloc(out_shapes, out_dtypes, device)
        aux = _alloc(aux_shapes, aux_dtypes, device)
        with autograd.pause(train_mode=autograd.is_training()):
            op.forward(autograd.is_training(), ["write"] * len(out_data),
                       in_data, out_data, aux)
        ctx.call = (prop, op, in_data, out_data, aux)
        in_ptrs = {t.data_ptr() for t in inputs}
        # an output that is an input's own tensor leaves the node as a copy
        return tuple(o._data.clone() if o._data.data_ptr() in in_ptrs
                     else o._data for o in out_data)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray import NDArray

        prop, op, in_data, out_data, aux = ctx.call
        out_grad = ([NDArray(torch.zeros_like(o._data) if g is None else g)
                     for g, o in zip(grads, out_data)]
                    if prop.need_top_grad_ else [])
        in_grad = [NDArray(torch.zeros_like(x._data)) for x in in_data]
        with autograd.pause():
            op.backward(["write"] * len(in_data), out_grad, in_data,
                        out_data, in_grad, aux)
        return (None,) + tuple(g._data for g in in_grad)


def Custom(*data, op_type=None, **kwargs):
    """``nd.Custom``: run the registered op ``op_type`` on ``data``
    (ref: src/operator/custom/custom.cc). Inside ``autograd.record()`` the
    call is one node of the graph, whose gradient is the op's
    ``backward``. Refuses to run inside a CUDA graph capture."""
    if op_type is None:
        raise ValueError("Custom(...) requires op_type=")
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "nd.Custom(op_type=%r) runs host Python: it cannot be captured "
            "into a CUDA graph (register a torch op with "
            "operator.register_torch_op instead)" % (op_type,))
    from .ndarray import NDArray, array, unwrap

    in_data = [x if isinstance(x, NDArray) else array(x) for x in data]
    call = _build(op_type, [x.shape for x in in_data],
                  [x.dtype for x in in_data], kwargs)
    rec = autograd.is_recording()
    ts = [unwrap(a, rec) for a in in_data]
    with torch.set_grad_enabled(rec):
        outs = _CustomNode.apply(call, *ts)
    if rec:
        autograd._record_entry(None, ts, {}, outs)
    wrapped = [NDArray(o) for o in outs]
    return wrapped[0] if len(wrapped) == 1 else wrapped


# ------------------------------------------------------------------ tier 1


def register_torch_op(name, fn, vjp=None, fwd=None, **reg_kwargs):
    """Register the torch function ``fn(*tensors, **static)`` as op
    ``name`` of the registry: ``nd.<name>``, recorded on the tape, and
    captured into a hybridized block's CUDA graph like any built-in op.
    Given ``vjp(residuals, grad) -> tuple of input grads`` the op's
    gradient is that (a ``torch.autograd.Function``); ``fwd(*tensors,
    **static) -> (out, residuals)`` defaults to ``(fn(...), tensors)``.
    Without ``vjp`` autograd differentiates ``fn``. ``reg_kwargs`` go to
    ``base.register_op`` (``nondiff``, ``needs_training``). Returns the
    registered function."""
    if vjp is None:
        register_op(name, **reg_kwargs)(fn)
        return fn
    f_fwd = fwd if fwd is not None else (
        lambda *xs, **static: (fn(*xs, **static), xs))

    class _Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, static, *xs):
            out, ctx.residuals = f_fwd(*xs, **static)
            return out

        @staticmethod
        def backward(ctx, *grads):
            g = grads[0] if len(grads) == 1 else grads
            return (None,) + tuple(vjp(ctx.residuals, g))

    def target(*xs, **static):
        return _Op.apply(static, *xs)

    target.__name__ = name
    target.__doc__ = fn.__doc__
    register_op(name, **reg_kwargs)(target)
    return target
