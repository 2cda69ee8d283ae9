"""Graph shape inference with parameter-shape deduction (counterpart of
``mxnet_tpu/shape_inference.py``; ref: src/executor/graph_executor.cc's
infer pass, nnvm's InferShape).

Forward propagation runs each node's registry op on ``meta`` tensors (the
port's ``jax.eval_shape``; the kernels' ``torch.library`` ops answer
through their fake implementations inside ``ops.cuda.shape_inference``).
Per-op parameter rules (:data:`PARAM_SHAPE_RULES`, the backward direction
of nnvm's InferShape) assign still-unknown parameter inputs from the op's
attrs and its data inputs' shapes, and the passes repeat until none
resolves a new variable, so a weight used before the node that fixes its
shape (a weight-decay term, a tied embedding) still resolves.
``sym.var("fc_weight")`` so needs no ``shape=`` when the graph's data
inputs are shaped, as with MXNet's ``simple_bind``. A node whose op fails
on meta tensors (a bad declared shape, or an op that cannot run without
data) is named in the error with its op and input shapes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["infer_shapes_partial", "infer_types", "meta_eval",
           "PARAM_SHAPE_RULES"]

# op name -> fn(node, in_shapes) -> {input index: shape} for unshaped
# parameter inputs, consulted when an input shape is unknown
PARAM_SHAPE_RULES = {}


def param_rule(op_name):
    def deco(fn):
        PARAM_SHAPE_RULES[op_name] = fn
        return fn
    return deco


def _conv_in_channels(x_shape, layout):
    # the conv ops keep OIHW weights for every data layout; only the data's
    # channel position depends on the layout
    return x_shape[1] if (layout or "NCHW").startswith("NC") else x_shape[-1]


@param_rule("FullyConnected")
def _fc_rule(node, ins):
    x = ins[0]
    nh = node._attrs.get("num_hidden")
    if x is None or nh is None:
        return {}
    flatten = node._attrs.get("flatten", True)
    in_dim = math.prod(x[1:]) if (flatten and len(x) > 2) else x[-1]
    out = {1: (nh, in_dim)}
    if len(node._inputs) > 2:
        out[2] = (nh,)
    return out


@param_rule("Convolution")
def _conv_rule(node, ins):
    x = ins[0]
    nf = node._attrs.get("num_filter")
    kernel = node._attrs.get("kernel")
    if x is None or nf is None or kernel is None:
        return {}
    kernel = (kernel,) if isinstance(kernel, int) else tuple(kernel)
    ng = node._attrs.get("num_group", 1)
    c = _conv_in_channels(x, node._attrs.get("layout"))
    out = {1: (nf, c // ng) + kernel}
    if len(node._inputs) > 2:
        out[2] = (nf,)
    return out


@param_rule("Deconvolution")
def _deconv_rule(node, ins):
    x = ins[0]
    nf = node._attrs.get("num_filter")
    kernel = node._attrs.get("kernel")
    if x is None or nf is None or kernel is None:
        return {}
    kernel = (kernel,) if isinstance(kernel, int) else tuple(kernel)
    ng = node._attrs.get("num_group", 1)
    c = _conv_in_channels(x, node._attrs.get("layout"))
    # MXNet's deconvolution weight: (in_channels, num_filter/num_group, *k)
    out = {1: (c, nf // ng) + kernel}
    if len(node._inputs) > 2:
        out[2] = (nf,)
    return out


@param_rule("BatchNorm")
def _bn_rule(node, ins):
    x = ins[0]
    if x is None:
        return {}
    c = x[node._attrs.get("axis", 1)]
    return {i: (c,) for i in range(1, len(node._inputs))}


@param_rule("InstanceNorm")
def _in_rule(node, ins):
    x = ins[0]
    if x is None:
        return {}
    return {i: (x[1],) for i in range(1, len(node._inputs))}


@param_rule("LayerNorm")
def _ln_rule(node, ins):
    x = ins[0]
    if x is None:
        return {}
    c = x[node._attrs.get("axis", -1)]
    return {i: (c,) for i in range(1, len(node._inputs))}


@param_rule("Embedding")
def _embed_rule(node, ins):
    di = node._attrs.get("input_dim")
    do = node._attrs.get("output_dim")
    if di is None or do is None:
        return {}
    return {1: (di, do)}


def _run_op(node, ins):
    """The node's op on the meta tensors ``ins``."""
    from .ops.cuda import shape_inference
    from .symbol import _on_device, _registry

    fn = _registry()[node._op]
    with torch.no_grad(), shape_inference(), _on_device(
            torch.device("meta")):
        return fn(*ins, **node._attrs)


def _meta_var(node, shape, int_vars=()):
    dt = node._dtype or (torch.int32 if node.name in int_vars
                         else torch.float32)
    return torch.empty(tuple(shape), dtype=dt, device="meta")


def meta_eval(sym):
    """``sym``'s output on meta tensors from the variables' declared
    shapes (memoized on every node); raises ``ValueError`` when a variable
    has none or a node fails, naming it."""
    from .symbol import _topo

    for s in _topo(sym):
        if "_meta_cache" in s.__dict__:
            continue
        if s.is_var():
            if s._shape is None:
                raise ValueError(
                    "cannot infer shape through %r: variable %r has no "
                    "declared shape (use var(name, shape=...))"
                    % (sym.name, s.name))
            val = _meta_var(s, s._shape)
        elif s._op == "_group":
            val = [i._meta_cache for i in s._inputs]
        elif s._op == "_item":
            p = s._inputs[0]._meta_cache
            idx = s._attrs["index"]
            val = p[idx] if isinstance(p, (list, tuple)) else p
        else:
            ins = [i._meta_cache for i in s._inputs]
            try:
                val = _run_op(s, ins)
            except Exception as e:
                raise ValueError("shape inference failed at %s: %s" % (
                    _describe(s, ins), _first_line(e))) from e
        s._meta_cache = val
    return sym._meta_cache


def _first_line(e):
    return (str(e).splitlines() or [""])[0]


def _describe(node, ins):
    return "%s %s(%s)" % (node.name, node._op, ", ".join(
        str(tuple(t.shape)) if isinstance(t, torch.Tensor) else repr(t)
        for t in ins))


def _shape_of(out):
    if isinstance(out, (list, tuple)):
        return [tuple(o.shape) for o in out]
    return tuple(out.shape)


def infer_shapes_partial(sym, known, int_vars=(), dtypes=None):
    """Infer shapes through ``sym``'s DAG given ``known`` var name →
    shape. Returns ``(var_shapes, out_shape, errors)``: every free
    variable's shape (None where undeterminable), the output shape (a
    tuple, a list for a group, or None) and {node name: why its op failed}.
    ``int_vars`` are probed as int32, ``dtypes`` (name → dtype) as given,
    everything else float32; ``dtypes`` also receives every node's output
    dtype by node name."""
    from .symbol import _topo

    var_shapes = {}
    errors = {}
    given = dict(dtypes or {})

    def run_pass():
        vals = {}
        progress = False
        for node in _topo(sym):
            if node.is_var():
                s = known.get(node.name) or var_shapes.get(node.name) or \
                    node._shape
                s = tuple(s) if s is not None else None
                if var_shapes.get(node.name) is None:
                    var_shapes[node.name] = s
                if s is None:
                    vals[id(node)] = None
                else:
                    dt = given.get(node.name)
                    t = _meta_var(node, s, int_vars)
                    vals[id(node)] = t if dt is None else t.to(dt)
                continue
            if node._op == "_group":
                vals[id(node)] = [vals[id(i)] for i in node._inputs]
                continue
            if node._op == "_item":
                p = vals[id(node._inputs[0])]
                idx = node._attrs["index"]
                vals[id(node)] = p[idx] if isinstance(p, list) else (
                    p if idx == 0 else None)
                continue
            ins = [vals[id(i)] for i in node._inputs]
            if any(v is None for v in ins):
                rule = PARAM_SHAPE_RULES.get(node._op)
                if rule is not None:
                    shapes = [None if v is None or isinstance(v, list)
                              else tuple(v.shape) for v in ins]
                    for idx, s in (rule(node, shapes) or {}).items():
                        child = node._inputs[idx]
                        if ins[idx] is None and s is not None and \
                                child.is_var():
                            var_shapes[child.name] = tuple(s)
                            ins[idx] = _meta_var(child, s, int_vars)
                            vals[id(child)] = ins[idx]
                            progress = True
            if any(v is None or isinstance(v, list) for v in ins):
                vals[id(node)] = None
                continue
            try:
                out = _run_op(node, ins)
            except Exception as e:
                errors[node.name] = "%s: %s" % (_describe(node, ins)[
                    len(node.name) + 1:], _first_line(e))
                vals[id(node)] = None
                continue
            errors.pop(node.name, None)
            vals[id(node)] = list(out) if isinstance(out, (list, tuple)) \
                else out
        return vals, progress

    for _ in range(len(sym._arg_symbols()) + 2):
        vals, progressed = run_pass()
        if not progressed:
            break
    out = vals[id(sym)]
    if dtypes is not None:
        for node in _topo(sym):
            v = vals.get(id(node))
            if isinstance(v, torch.Tensor):
                dtypes[node.name] = v.dtype
    if out is None:
        return var_shapes, None, errors
    if isinstance(out, list):
        return var_shapes, [None if o is None else _shape_of(o)
                            for o in out], errors
    return var_shapes, _shape_of(out), errors


def format_infer_errors(errors):
    if not errors:
        return ""
    return "; node failures: " + "; ".join(
        "%s -> %s" % (k, v) for k, v in list(errors.items())[:5])


def _np_type(dt):
    from .ndarray import np_dtype

    d = np_dtype(dt)
    return d.type if isinstance(d, np.dtype) else d


def infer_types(sym, given):
    """(argument types, output types, []) with ``given`` (name → dtype)
    and float32 for the rest; shapes come from the declared ones, and
    where a shape is unknown the type of an argument is what it was
    given (float32 by default)."""
    from .base import resolve_dtype

    names = sym.list_arguments()
    dts = {n: resolve_dtype(d) for n, d in given.items()}
    shapes = {s.name: s._shape for s in sym._arg_symbols()
              if s._shape is not None}
    out_types = None
    if len(shapes) == len(names):
        found = dict(dts)
        _, out, _ = infer_shapes_partial(sym, shapes, dtypes=found)
        heads = sym._inputs if sym._op == "_group" else [sym]
        if out is not None and all(h.name in found for h in heads):
            out_types = [_np_type(found[h.name]) for h in heads]
    arg_types = [_np_type(dts.get(n, torch.float32)) for n in names]
    if out_types is None:
        heads = sym._inputs if sym._op == "_group" else [sym]
        out_types = [np.float32] * len(heads)
    return arg_types, out_types, []
