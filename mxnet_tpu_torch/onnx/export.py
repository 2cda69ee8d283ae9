"""Symbol graph → ONNX ModelProto (counterpart of
``mxnet_tpu/onnx/export.py``; ref: python/mxnet/onnx/mx2onnx/_export_model.py
and _op_translations — the reference converts nnvm symbol nodes to ONNX nodes
one converter per op; this does the same over the port's Symbol DAG, whose
op names are the JAX package's, so a model either package traces exports to
the same nodes, attributes and initializers).

Entry points:
  export_model(block_or_symbol, params_or_shapes, ..., onnx_file)

A HybridBlock is first traced to a Symbol graph via ``block(sym.var('data'))``;
each Symbol node is then translated by a converter. Inference semantics:
BatchNorm exports running-stat normalization, Dropout exports identity-at-eval.
"""
from __future__ import annotations

import numpy as np

from . import proto as P
from ..symbol import Symbol

_CONVERTERS = {}


def register_converter(opname):
    def deco(fn):
        _CONVERTERS[opname] = fn
        return fn
    return deco


class _Ctx:
    """Per-export state: emitted nodes, initializers, name table."""

    def __init__(self, params, opset):
        self.nodes = []
        self.initializers = {}
        self.names = {}     # id(symbol) -> output value name
        self.multi = {}     # id(symbol) -> [name per output] for multi-output ops
        self.params = params
        self.opset = opset
        self._uid = 0

    def fresh(self, hint):
        self._uid += 1
        return "%s_%d" % (hint, self._uid)

    def emit(self, op_type, inputs, outputs, name=None, attrs=None):
        self.nodes.append(P.node_proto(op_type, inputs, outputs,
                                       name or self.fresh(op_type.lower()),
                                       attrs or {}))

    def const(self, hint, arr):
        """Add an initializer tensor, return its name."""
        name = self.fresh(hint)
        self.initializers[name] = np.asarray(arr)
        return name


def _pair(v, n=2):
    return list(v) if isinstance(v, (tuple, list)) else [v] * n


def _np_dtype(dtype):
    """numpy's dtype for a registry dtype name or torch dtype (bfloat16
    as ``ml_dtypes.bfloat16``, where installed)."""
    import torch

    from ..base import resolve_dtype

    t = resolve_dtype(dtype)
    if t == torch.bfloat16:
        return P._bf16_dtype()
    return torch.empty(0, dtype=t).numpy().dtype


def _kernel(s):
    """A convolution's window: its ``kernel`` attr, which the JAX
    package's layers write and the port's leave to the weight, else the
    weight's trailing dims."""
    k = s._attrs.get("kernel")
    if k is None:
        k = tuple(s._inputs[1].shape[2:])
    return _pair(k)


# ------------------------------------------------------------- op converters
# Each converter: (ctx, node, in_names) -> out_name (or list of out names).

@register_converter("Convolution")
def _conv(ctx, s, ins, out):
    a = s._attrs
    kernel = _kernel(s)
    nd = len(kernel)
    pads = _pair(a.get("pad", 0), nd)
    attrs = {"kernel_shape": kernel,
             "strides": _pair(a.get("stride", 1), nd),
             "pads": pads + pads,   # begin then end
             "dilations": _pair(a.get("dilate", 1), nd),
             "group": int(a.get("num_group", 1))}
    ctx.emit("Conv", ins, [out], attrs=attrs)


@register_converter("Deconvolution")
def _deconv(ctx, s, ins, out):
    a = s._attrs
    kernel = _kernel(s)
    nd = len(kernel)
    pads = _pair(a.get("pad", 0), nd)
    attrs = {"kernel_shape": kernel,
             "strides": _pair(a.get("stride", 1), nd),
             "pads": pads + pads,
             "dilations": _pair(a.get("dilate", 1), nd),
             "group": int(a.get("num_group", 1))}
    adj = a.get("adj")
    if adj:
        attrs["output_padding"] = _pair(adj, nd)
    ctx.emit("ConvTranspose", ins, [out], attrs=attrs)


@register_converter("FullyConnected")
def _fc(ctx, s, ins, out):
    a = s._attrs
    x = ins[0]
    if a.get("flatten", True):
        flat = ctx.fresh("flatten")
        ctx.emit("Flatten", [x], [flat], attrs={"axis": 1})
        # Gemm: Y = X·Wᵀ + b  (MXNet weight is (num_hidden, in))
        gemm_in = [flat, ins[1]] + ins[2:3]
        ctx.emit("Gemm", gemm_in, [out], attrs={"transB": 1, "alpha": 1.0, "beta": 1.0})
    else:
        # N-D input: MatMul against Wᵀ then Add bias
        wt = ctx.fresh("w_t")
        ctx.emit("Transpose", [ins[1]], [wt], attrs={"perm": [1, 0]})
        mm = ctx.fresh("matmul") if len(ins) > 2 else out
        ctx.emit("MatMul", [x, wt], [mm])
        if len(ins) > 2:
            ctx.emit("Add", [mm, ins[2]], [out])


@register_converter("BatchNorm")
def _bn(ctx, s, ins, out):
    a = s._attrs
    # inputs arrive as (x, gamma, beta, moving_mean, moving_var) = ONNX order
    ctx.emit("BatchNormalization", ins[:5], [out],
             attrs={"epsilon": float(a.get("eps", 1e-5)),
                    "momentum": float(a.get("momentum", 0.9))})


@register_converter("LayerNorm")
def _ln(ctx, s, ins, out):
    a = s._attrs
    ctx.emit("LayerNormalization", ins[:3], [out],
             attrs={"axis": int(a.get("axis", -1)),
                    "epsilon": float(a.get("eps", 1e-5))})


_ACT2ONNX = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
             "softrelu": "Softplus", "softsign": "Softsign"}


@register_converter("Activation")
def _act(ctx, s, ins, out):
    act = s._attrs.get("act_type", "relu")
    if act in ("gelu", "gelu_erf"):
        # exact-erf gelu decomposed for opset 13 (ONNX Gelu is opset 20):
        # 0.5 * x * (1 + erf(x / sqrt(2)))
        inv = ctx.const("gelu_inv_sqrt2", np.float32(1.0 / np.sqrt(2.0)))
        sc = ctx.fresh("gelu_scaled")
        ctx.emit("Mul", [ins[0], inv], [sc])
        er = ctx.fresh("gelu_erf")
        ctx.emit("Erf", [sc], [er])
        one = ctx.const("gelu_one", np.float32(1.0))
        ad = ctx.fresh("gelu_1p")
        ctx.emit("Add", [er, one], [ad])
        half = ctx.const("gelu_half", np.float32(0.5))
        hx = ctx.fresh("gelu_halfx")
        ctx.emit("Mul", [ins[0], half], [hx])
        ctx.emit("Mul", [hx, ad], [out])
        return
    ctx.emit(_ACT2ONNX[act], ins[:1], [out])


@register_converter("LeakyReLU")
def _leaky(ctx, s, ins, out):
    a = s._attrs
    act = a.get("act_type", "leaky")
    if act == "leaky":
        ctx.emit("LeakyRelu", ins[:1], [out],
                 attrs={"alpha": float(a.get("slope", 0.25))})
    elif act == "elu":
        ctx.emit("Elu", ins[:1], [out], attrs={"alpha": float(a.get("slope", 0.25))})
    elif act == "prelu":
        ctx.emit("PRelu", ins[:2], [out])
    elif act == "gelu":
        ctx.emit("Gelu", ins[:1], [out])
    elif act == "selu":
        ctx.emit("Selu", ins[:1], [out])
    else:
        raise ValueError("cannot export LeakyReLU act_type=%s" % act)


@register_converter("Pooling")
def _pool(ctx, s, ins, out):
    a = s._attrs
    ptype = a.get("pool_type", "max")
    if a.get("global_pool"):
        op = {"max": "GlobalMaxPool", "avg": "GlobalAveragePool"}[ptype]
        ctx.emit(op, ins[:1], [out])
        return
    kernel = _pair(a.get("kernel"))
    nd = len(kernel)
    pads = _pair(a.get("pad", 0), nd)
    attrs = {"kernel_shape": kernel,
             "strides": _pair(a.get("stride") or a.get("kernel"), nd),
             "pads": pads + pads}
    if ptype == "avg":
        attrs["count_include_pad"] = int(bool(a.get("count_include_pad", True)))
        ctx.emit("AveragePool", ins[:1], [out], attrs=attrs)
    elif ptype == "max":
        ctx.emit("MaxPool", ins[:1], [out], attrs=attrs)
    elif ptype == "lp":
        attrs["p"] = int(a.get("p_value", 2))
        ctx.emit("LpPool", ins[:1], [out], attrs=attrs)
    else:
        raise ValueError("cannot export pool_type=%s" % ptype)


@register_converter("Dropout")
def _dropout(ctx, s, ins, out):
    ctx.emit("Dropout", ins[:1], [out],
             attrs={})  # inference: identity; ratio only matters in training


@register_converter("Embedding")
def _embedding(ctx, s, ins, out):
    # F.Embedding(indices, weight) → Gather(weight, indices)
    ctx.emit("Gather", [ins[1], ins[0]], [out], attrs={"axis": 0})


@register_converter("flatten")
def _flatten(ctx, s, ins, out):
    ctx.emit("Flatten", ins, [out], attrs={"axis": 1})


@register_converter("softmax")
def _softmax(ctx, s, ins, out):
    ctx.emit("Softmax", ins[:1], [out], attrs={"axis": int(s._attrs.get("axis", -1))})


@register_converter("log_softmax")
def _log_softmax(ctx, s, ins, out):
    ctx.emit("LogSoftmax", ins[:1], [out], attrs={"axis": int(s._attrs.get("axis", -1))})


@register_converter("concat")
def _concat(ctx, s, ins, out):
    ctx.emit("Concat", ins, [out], attrs={"axis": int(s._attrs.get("dim", 1))})


@register_converter("reshape")
def _reshape(ctx, s, ins, out):
    shape = ctx.const("shape", np.asarray(s._attrs["shape"], np.int64))
    ctx.emit("Reshape", [ins[0], shape], [out])


@register_converter("transpose")
def _transpose(ctx, s, ins, out):
    attrs = {}
    if s._attrs.get("axes") is not None:
        attrs["perm"] = list(s._attrs["axes"])
    ctx.emit("Transpose", ins, [out], attrs=attrs)


@register_converter("expand_dims")
def _expand_dims(ctx, s, ins, out):
    axes = ctx.const("axes", np.asarray([s._attrs["axis"]], np.int64))
    ctx.emit("Unsqueeze", [ins[0], axes], [out])


@register_converter("squeeze")
def _squeeze(ctx, s, ins, out):
    ax = s._attrs.get("axis")
    if ax is None:
        ctx.emit("Squeeze", ins, [out])
    else:
        ax = [ax] if isinstance(ax, int) else list(ax)
        axes = ctx.const("axes", np.asarray(ax, np.int64))
        ctx.emit("Squeeze", [ins[0], axes], [out])


@register_converter("clip")
def _clip(ctx, s, ins, out):
    # each bound independently from attrs (keyword form) or the next _const
    # input (positional form) — mixed calls like clip(x, -1, a_max=1) are
    # legal Python and record one of each
    nxt = [1]

    def bound(name):
        if name in s._attrs:
            return s._attrs[name]
        inp = s._inputs[nxt[0]]
        nxt[0] += 1
        if inp._op != "_const":
            raise ValueError(
                "clip: %s must be a scalar constant for ONNX export" % name)
        return inp._attrs["value"]

    lo = ctx.const("min", np.float32(bound("a_min")))
    hi = ctx.const("max", np.float32(bound("a_max")))
    ctx.emit("Clip", [ins[0], lo, hi], [out])


def _reduce(onnx_op):
    def conv(ctx, s, ins, out):
        a = s._attrs
        attrs = {"keepdims": int(bool(a.get("keepdims", False)))}
        ax = a.get("axis")
        axes = None if ax is None else ([ax] if isinstance(ax, int) else list(ax))
        if onnx_op == "ReduceSum" and axes is not None:
            # opset 13 moved ReduceSum's axes from attribute to input
            axes_in = ctx.const("axes", np.asarray(axes, np.int64))
            ctx.emit(onnx_op, [ins[0], axes_in], [out], attrs=attrs)
            return
        if axes is not None:
            attrs["axes"] = axes
        ctx.emit(onnx_op, ins[:1], [out], attrs=attrs)
    return conv


for _mx, _onnx in [("mean", "ReduceMean"), ("sum", "ReduceSum"),
                   ("max", "ReduceMax"), ("min", "ReduceMin"),
                   ("prod", "ReduceProd")]:
    register_converter(_mx)(_reduce(_onnx))


def _binop(onnx_op):
    def conv(ctx, s, ins, out):
        ctx.emit(onnx_op, ins[:2], [out])
    return conv


for _mx, _onnx in [("add", "Add"), ("subtract", "Sub"), ("multiply", "Mul"),
                   ("divide", "Div"), ("power", "Pow"), ("maximum", "Max"),
                   ("minimum", "Min"), ("broadcast_add", "Add"),
                   ("broadcast_sub", "Sub"), ("broadcast_mul", "Mul"),
                   ("broadcast_div", "Div"), ("broadcast_power", "Pow"),
                   ("broadcast_maximum", "Max"), ("broadcast_minimum", "Min"),
                   ("dot", "MatMul"), ("matmul", "MatMul"),
                   ("batch_dot", "MatMul")]:
    register_converter(_mx)(_binop(_onnx))


def _unop(onnx_op):
    def conv(ctx, s, ins, out):
        ctx.emit(onnx_op, ins[:1], [out])
    return conv


for _mx, _onnx in [("relu", "Relu"), ("sigmoid", "Sigmoid"), ("tanh", "Tanh"),
                   ("exp", "Exp"), ("log", "Log"), ("sqrt", "Sqrt"),
                   ("negative", "Neg"), ("abs", "Abs"), ("floor", "Floor"),
                   ("ceil", "Ceil"), ("round", "Round"), ("erf", "Erf"),
                   ("sin", "Sin"), ("cos", "Cos"), ("tan", "Tan"),
                   ("reciprocal", "Reciprocal"), ("sign", "Sign"),
                   ("softsign", "Softsign"), ("softrelu", "Softplus")]:
    register_converter(_mx)(_unop(_onnx))


for _mx, _onnx in [("arcsin", "Asin"), ("arccos", "Acos"),
                   ("arctan", "Atan"), ("sinh", "Sinh"), ("cosh", "Cosh"),
                   ("arcsinh", "Asinh"), ("arccosh", "Acosh"),
                   ("arctanh", "Atanh")]:
    register_converter(_mx)(_unop(_onnx))


_F32 = 1  # onnx TensorProto.FLOAT


def _cmpop(onnx_op, negate=False):
    """MXNet comparisons return float 0/1; ONNX returns bool → Cast back
    (f32, the framework's default compute dtype)."""
    def conv(ctx, s, ins, out):
        b = ctx.fresh("cmp")
        ctx.emit(onnx_op, ins[:2], [b])
        if negate:
            nb = ctx.fresh("not")
            ctx.emit("Not", [b], [nb])
            b = nb
        ctx.emit("Cast", [b], [out], attrs={"to": _F32})
    return conv


for _mx, _onnx, _neg in [
        ("broadcast_equal", "Equal", False),
        ("broadcast_not_equal", "Equal", True),
        ("broadcast_greater", "Greater", False),
        ("broadcast_greater_equal", "GreaterOrEqual", False),
        ("broadcast_lesser", "Less", False),
        ("broadcast_lesser_equal", "LessOrEqual", False),
        ("equal", "Equal", False), ("not_equal", "Equal", True),
        ("greater", "Greater", False),
        ("greater_equal", "GreaterOrEqual", False),
        ("lesser", "Less", False), ("lesser_equal", "LessOrEqual", False)]:
    register_converter(_mx)(_cmpop(_onnx, _neg))


_BOOL = 9  # onnx TensorProto.BOOL


def _logicop(onnx_op):
    def conv(ctx, s, ins, out):
        bs = []
        for i in ins[:2]:
            b = ctx.fresh("b")
            ctx.emit("Cast", [i], [b], attrs={"to": _BOOL})
            bs.append(b)
        r = ctx.fresh("logic")
        ctx.emit(onnx_op, bs, [r])
        ctx.emit("Cast", [r], [out], attrs={"to": _F32})
    return conv


for _mx, _onnx in [("logical_and", "And"), ("logical_or", "Or"),
                   ("logical_xor", "Xor"),
                   ("broadcast_logical_and", "And"),
                   ("broadcast_logical_or", "Or"),
                   ("broadcast_logical_xor", "Xor")]:
    register_converter(_mx)(_logicop(_onnx))


@register_converter("logical_not")
def _logical_not(ctx, s, ins, out):
    b = ctx.fresh("b")
    ctx.emit("Cast", ins[:1], [b], attrs={"to": _BOOL})
    r = ctx.fresh("not")
    ctx.emit("Not", [b], [r])
    ctx.emit("Cast", [r], [out], attrs={"to": _F32})


@register_converter("mod")
def _mod_conv(ctx, s, ins, out):
    # framework mod is floor modulo (torch.remainder, sign of divisor); ONNX Mod on
    # floats requires fmod=1 (truncation, sign of dividend) — decompose
    # instead: x - floor(x/y)*y, exact for both signs
    q = ctx.fresh("div")
    ctx.emit("Div", ins[:2], [q])
    fq = ctx.fresh("floor")
    ctx.emit("Floor", [q], [fq])
    prod = ctx.fresh("mul")
    ctx.emit("Mul", [fq, ins[1]], [prod])
    ctx.emit("Sub", [ins[0], prod], [out])


def _argop(onnx_op):
    def conv(ctx, s, ins, out):
        a = s._attrs
        ax = a.get("axis")
        attrs = {"axis": int(ax) if ax is not None else 0,
                 "keepdims": int(bool(a.get("keepdims", False)))}
        if ax is None:
            flat = ctx.fresh("flat")
            shp = ctx.const("shape", np.asarray([-1], np.int64))
            ctx.emit("Reshape", [ins[0], shp], [flat])
            r = ctx.fresh("arg")
            ctx.emit(onnx_op, [flat], [r], attrs=attrs)
            ctx.emit("Cast", [r], [out], attrs={"to": _F32})
            return
        r = ctx.fresh("arg")
        ctx.emit(onnx_op, ins[:1], [r], attrs=attrs)
        # MXNet argmax/argmin return float; ONNX returns int64
        ctx.emit("Cast", [r], [out], attrs={"to": _F32})
    return conv


register_converter("argmax")(_argop("ArgMax"))
register_converter("argmin")(_argop("ArgMin"))


@register_converter("norm")
def _norm_conv(ctx, s, ins, out):
    a = s._attrs
    ordv = int(a.get("ord", 2))
    op = {1: "ReduceL1", 2: "ReduceL2"}.get(ordv)
    if op is None:
        raise ValueError("norm export: only ord 1/2 map to ONNX ReduceL1/L2")
    attrs = {"keepdims": int(bool(a.get("keepdims", False)))}
    ax = a.get("axis")
    if ax is not None:
        attrs["axes"] = [ax] if isinstance(ax, int) else list(ax)
    ctx.emit(op, ins[:1], [out], attrs=attrs)


@register_converter("stack")
def _stack_conv(ctx, s, ins, out):
    axis = int(s._attrs.get("axis", 0))
    ax_in = ctx.const("axes", np.asarray([axis], np.int64))
    unsq = []
    for i in ins:
        u = ctx.fresh("unsq")
        ctx.emit("Unsqueeze", [i, ax_in], [u])
        unsq.append(u)
    ctx.emit("Concat", unsq, [out], attrs={"axis": axis})


@register_converter("take")
def _take_conv(ctx, s, ins, out):
    a = s._attrs
    mode = a.get("mode", "clip")
    if mode not in ("clip", "raise"):
        raise ValueError("take export: mode=%r unsupported" % mode)
    axis = int(a.get("axis", 0))
    idx = ctx.fresh("idx")
    ctx.emit("Cast", [ins[1]], [idx], attrs={"to": 7})  # int64 indices
    if mode == "clip":
        # ONNX Gather is out-of-bounds-undefined; reproduce MXNet's clamp
        # with Clip(idx, 0, dim-1). Static dim when the traced shape is
        # known (the usual export path), Shape-at-runtime otherwise.
        try:
            data_shape = s._inputs[0].shape
        except ValueError:
            data_shape = None
        zero = ctx.const("zero", np.asarray(0, np.int64))
        if data_shape is not None:
            hi = ctx.const("hi", np.asarray(data_shape[axis] - 1, np.int64))
        else:
            shp = ctx.fresh("shape")
            ctx.emit("Shape", [ins[0]], [shp])
            ax_c = ctx.const("axidx", np.asarray(axis, np.int64))
            dim = ctx.fresh("dim")
            ctx.emit("Gather", [shp, ax_c], [dim], attrs={"axis": 0})
            one = ctx.const("one", np.asarray(1, np.int64))
            hi = ctx.fresh("hi")
            ctx.emit("Sub", [dim, one], [hi])
        clipped = ctx.fresh("clipped")
        ctx.emit("Clip", [idx, zero, hi], [clipped])
        idx = clipped
    ctx.emit("Gather", [ins[0], idx], [out], attrs={"axis": axis})


@register_converter("InstanceNorm")
def _instance_norm_conv(ctx, s, ins, out):
    ctx.emit("InstanceNormalization", ins[:3], [out],
             attrs={"epsilon": float(s._attrs.get("eps", 1e-5))})


@register_converter("LRN")
def _lrn_conv(ctx, s, ins, out):
    a = s._attrs
    ctx.emit("LRN", ins[:1], [out], attrs={
        "size": int(a.get("nsize", 5)), "alpha": float(a.get("alpha", 1e-4)),
        "beta": float(a.get("beta", 0.75)), "bias": float(a.get("knorm", 2.0))})


@register_converter("L2Normalization")
def _l2norm_conv(ctx, s, ins, out):
    mode = s._attrs.get("mode", "instance")
    if mode != "channel":
        raise ValueError("L2Normalization export: only mode='channel' maps "
                         "to ONNX LpNormalization (axis semantics)")
    ctx.emit("LpNormalization", ins[:1], [out], attrs={"axis": 1, "p": 2})


@register_converter("log1p")
def _log1p_conv(ctx, s, ins, out):
    one = ctx.const("one", np.float32(1.0))
    ap = ctx.fresh("add")
    ctx.emit("Add", [ins[0], one], [ap])
    ctx.emit("Log", [ap], [out])


@register_converter("expm1")
def _expm1_conv(ctx, s, ins, out):
    one = ctx.const("one", np.float32(1.0))
    e = ctx.fresh("exp")
    ctx.emit("Exp", ins[:1], [e])
    ctx.emit("Sub", [e, one], [out])


@register_converter("rsqrt")
def _rsqrt_conv(ctx, s, ins, out):
    r = ctx.fresh("sqrt")
    ctx.emit("Sqrt", ins[:1], [r])
    ctx.emit("Reciprocal", [r], [out])


@register_converter("hard_sigmoid")
def _hard_sigmoid_conv(ctx, s, ins, out):
    a = s._attrs
    ctx.emit("HardSigmoid", ins[:1], [out],
             attrs={"alpha": float(a.get("alpha", 0.2)),
                    "beta": float(a.get("beta", 0.5))})


@register_converter("depth_to_space")
def _d2s_conv(ctx, s, ins, out):
    ctx.emit("DepthToSpace", ins[:1], [out],
             attrs={"blocksize": int(s._attrs["block_size"]), "mode": "DCR"})


@register_converter("space_to_depth")
def _s2d_conv(ctx, s, ins, out):
    ctx.emit("SpaceToDepth", ins[:1], [out],
             attrs={"blocksize": int(s._attrs["block_size"])})


@register_converter("gather_nd")
def _gather_nd_export(ctx, s, ins, out):
    # MXNet gather_nd leads with the index-tuple axis; ONNX GatherND wants
    # indices (..., index_depth) — move the leading axis to the back
    try:
        rank = len(s._inputs[1].shape)
    except ValueError:
        raise ValueError("gather_nd export needs a known indices rank for "
                         "the layout transpose")
    idx = ctx.fresh("idx")
    ctx.emit("Cast", [ins[1]], [idx], attrs={"to": 7})
    tr = ctx.fresh("tr")
    ctx.emit("Transpose", [idx], [tr],
             attrs={"perm": list(range(1, rank)) + [0]})
    ctx.emit("GatherND", [ins[0], tr], [out])


@register_converter("square")
def _square(ctx, s, ins, out):
    two = ctx.const("two", np.float32(2.0))
    ctx.emit("Pow", [ins[0], two], [out])


@register_converter("slice_axis")
def _slice_axis(ctx, s, ins, out):
    a = s._attrs
    end = a.get("end")
    starts = ctx.const("starts", np.asarray([a["begin"]], np.int64))
    ends = ctx.const("ends", np.asarray(
        [end if end is not None else np.iinfo(np.int64).max], np.int64))
    axes = ctx.const("axes", np.asarray([a["axis"]], np.int64))
    ctx.emit("Slice", [ins[0], starts, ends, axes], [out])


@register_converter("_const")
def _const_conv(ctx, s, ins, out):
    val = np.asarray(s._attrs["value"], np.float32)
    ctx.initializers[out] = val


@register_converter("_filled")
def _filled_conv(ctx, s, ins, out):
    a = s._attrs
    ctx.initializers[out] = np.full(tuple(a["shape"]), a["value"],
                                    _np_dtype(a.get("dtype", "float32")))


@register_converter("zeros_like")
def _zeros_like_conv(ctx, s, ins, out):
    # Shape→ConstantOfShape, not Mul(x, 0): type-correct for any dtype and
    # immune to 0·inf = NaN
    shp = ctx.fresh("shape")
    ctx.emit("Shape", [ins[0]], [shp])
    ctx.emit("ConstantOfShape", [shp], [out],
             attrs={"value": np.zeros(1, np.float32)})


@register_converter("multibox_prior")
def _multibox_prior_conv(ctx, s, ins, out):
    """Anchors depend only on the (static) feature-map shape and attrs, so
    they export as a precomputed constant initializer (upstream mx2onnx
    lowers _contrib_MultiBoxPrior the same way when shapes are static)."""
    import torch

    from ..base import OP_REGISTRY

    shape = s._inputs[0].shape  # requires var shapes (set by symbol_to_onnx)
    a = dict(s._attrs)
    x = torch.zeros(shape, dtype=torch.float32)
    anchors = OP_REGISTRY["multibox_prior"](x, **a)
    ctx.initializers[out] = anchors.detach().cpu().numpy().astype(np.float32)


@register_converter("_onnx_shape")
def _onnx_shape_conv(ctx, s, ins, out):
    ctx.emit("Shape", ins[:1], [out])


@register_converter("cast")
def _cast_conv(ctx, s, ins, out):
    code = P.np_to_onnx_dtype(_np_dtype(s._attrs["dtype"]))
    ctx.emit("Cast", ins[:1], [out], attrs={"to": int(code)})


# ---- flat legacy aliases: same semantics as an already-registered converter
def _alias_conv(target):
    def conv(ctx, s, ins, out):
        return _CONVERTERS[target](ctx, s, ins, out)
    return conv


for _legacy, _target in [("Cast", "cast"), ("Concat", "concat"),
                         ("Flatten", "flatten"), ("Reshape", "reshape"),
                         ("elemwise_add", "add"), ("elemwise_sub", "subtract"),
                         ("elemwise_mul", "multiply"),
                         ("elemwise_div", "divide"),
                         ("broadcast_mod", "mod")]:
    register_converter(_legacy)(_alias_conv(_target))


def _identity_conv(ctx, s, ins, out):
    ctx.emit("Identity", ins[:1], [out])


# BlockGrad/stop_gradient is Identity at inference (ONNX has no grad graph)
for _nm in ("identity", "BlockGrad", "stop_gradient"):
    register_converter(_nm)(_identity_conv)


@register_converter("ElementWiseSum")
def _ews_conv(ctx, s, ins, out):
    ctx.emit("Sum", ins, [out])


register_converter("add_n")(_ews_conv)


@register_converter("SwapAxis")
def _swapaxis_conv(ctx, s, ins, out):
    try:
        shape = s._inputs[0].shape  # meta-tensor shape inference through the graph
    except ValueError:
        raise ValueError("SwapAxis export needs a known input rank")
    perm = list(range(len(shape)))
    d1 = int(s._attrs.get("dim1", 0))
    d2 = int(s._attrs.get("dim2", 0))
    perm[d1], perm[d2] = perm[d2], perm[d1]
    ctx.emit("Transpose", ins[:1], [out], attrs={"perm": perm})


@register_converter("SoftmaxActivation")
def _softmax_act_conv(ctx, s, ins, out):
    if s._attrs.get("mode", "instance") != "instance":
        raise ValueError("SoftmaxActivation export: channel mode unsupported")
    # instance mode normalizes over ALL trailing dims per sample
    # (ops/extra.py:SoftmaxActivation flattens) — rank > 2 needs the
    # flatten/softmax/restore decomposition
    shape = s._inputs[0].shape
    if len(shape) <= 2:
        ctx.emit("Softmax", ins[:1], [out], attrs={"axis": -1})
        return
    flat = ctx.fresh("sa_flat")
    ctx.emit("Reshape", [ins[0], ctx.const(
        "fshape", np.asarray([shape[0], -1], np.int64))], [flat])
    sm = ctx.fresh("sa_softmax")
    ctx.emit("Softmax", [flat], [sm], attrs={"axis": -1})
    ctx.emit("Reshape", [sm, ctx.const(
        "rshape", np.asarray(shape, np.int64))], [out])


@register_converter("hypot")
def _hypot_conv(ctx, s, ins, out):
    # overflow-safe (torch.hypot semantics): m·sqrt(1 + (n/m)²) with
    # m = max(|x|,|y|) — naive sqrt(x²+y²) infs above ~1.8e19 in f32
    ab = []
    for i in ins[:2]:
        a = ctx.fresh("abs")
        ctx.emit("Abs", [i], [a])
        ab.append(a)
    mx = ctx.fresh("hmax")
    ctx.emit("Max", ab, [mx])
    mn = ctx.fresh("hmin")
    ctx.emit("Min", ab, [mn])
    denom = ctx.fresh("hden")
    ctx.emit("Max", [mx, ctx.const("tiny", np.float32(1e-38))], [denom])
    t = ctx.fresh("hratio")
    ctx.emit("Div", [mn, denom], [t])
    t2 = ctx.fresh("ht2")
    ctx.emit("Mul", [t, t], [t2])
    onep = ctx.fresh("h1p")
    ctx.emit("Add", [t2, ctx.const("one", np.float32(1.0))], [onep])
    rt = ctx.fresh("hsqrt")
    ctx.emit("Sqrt", [onep], [rt])
    ctx.emit("Mul", [mx, rt], [out])


register_converter("broadcast_hypot")(_CONVERTERS["hypot"])


@register_converter("mish")
def _mish_conv(ctx, s, ins, out):
    sp = ctx.fresh("softplus")
    ctx.emit("Softplus", ins[:1], [sp])
    th = ctx.fresh("tanh")
    ctx.emit("Tanh", [sp], [th])
    ctx.emit("Mul", [ins[0], th], [out])


@register_converter("log_sigmoid")
def _log_sigmoid_conv(ctx, s, ins, out):
    # log(sigmoid(x)) = -softplus(-x)
    ng = ctx.fresh("neg")
    ctx.emit("Neg", ins[:1], [ng])
    sp = ctx.fresh("softplus")
    ctx.emit("Softplus", [ng], [sp])
    ctx.emit("Neg", [sp], [out])


def _float_unop_via(onnx_pred):
    """IsNaN/IsInf return bool; MXNet isnan/isinf return float 0/1."""
    def conv(ctx, s, ins, out):
        b = ctx.fresh("pred")
        ctx.emit(onnx_pred, ins[:1], [b])
        ctx.emit("Cast", [b], [out], attrs={"to": int(P.FLOAT)})
    return conv


register_converter("isnan")(_float_unop_via("IsNaN"))
register_converter("isinf")(_float_unop_via("IsInf"))


@register_converter("isfinite")
def _isfinite_conv(ctx, s, ins, out):
    nn = ctx.fresh("isnan")
    ctx.emit("IsNaN", ins[:1], [nn])
    ii = ctx.fresh("isinf")
    ctx.emit("IsInf", ins[:1], [ii])
    either = ctx.fresh("or")
    ctx.emit("Or", [nn, ii], [either])
    nb = ctx.fresh("not")
    ctx.emit("Not", [either], [nb])
    ctx.emit("Cast", [nb], [out], attrs={"to": int(P.FLOAT)})


def _scale_by(factor, hint):
    def conv(ctx, s, ins, out):
        f = ctx.const(hint, np.float32(factor))
        ctx.emit("Mul", [ins[0], f], [out])
    return conv


def _scaled_log(base, hint):
    def conv(ctx, s, ins, out):
        ln = ctx.fresh("ln")
        ctx.emit("Log", ins[:1], [ln])
        _scale_by(1.0 / np.log(base), hint)(ctx, s, [ln], out)
    return conv


register_converter("log2")(_scaled_log(2.0, "invln2"))
register_converter("log10")(_scaled_log(10.0, "invln10"))
register_converter("degrees")(_scale_by(180.0 / np.pi, "r2d"))
register_converter("radians")(_scale_by(np.pi / 180.0, "d2r"))


@register_converter("cbrt")
def _cbrt_conv(ctx, s, ins, out):
    # sign(x)·|x|^(1/3): plain Pow would NaN on negative inputs
    sg = ctx.fresh("sign")
    ctx.emit("Sign", ins[:1], [sg])
    ab = ctx.fresh("abs")
    ctx.emit("Abs", ins[:1], [ab])
    third = ctx.const("third", np.float32(1.0 / 3.0))
    pw = ctx.fresh("pow")
    ctx.emit("Pow", [ab, third], [pw])
    ctx.emit("Mul", [sg, pw], [out])


@register_converter("trunc")
def _trunc_conv(ctx, s, ins, out):
    # trunc = sign(x)·floor(|x|)  (ONNX has no Trunc node)
    sg = ctx.fresh("sign")
    ctx.emit("Sign", ins[:1], [sg])
    ab = ctx.fresh("abs")
    ctx.emit("Abs", ins[:1], [ab])
    fl = ctx.fresh("floor")
    ctx.emit("Floor", [ab], [fl])
    ctx.emit("Mul", [sg, fl], [out])


register_converter("fix")(_CONVERTERS["trunc"])


def _emit_grid_sample(ctx, data, grid_nchw, out):
    """grid (N, 2, H, W) [-1,1] (x,y) → ONNX GridSample's (N, H, W, 2);
    MXNet's corner mapping x_src=(x+1)(W-1)/2 IS align_corners=1, and its
    zero out-of-bounds taps are padding_mode='zeros'."""
    if ctx.opset < 16:
        raise ValueError("BilinearSampler/SpatialTransformer export needs "
                         "opset>=16 (GridSample); pass opset=16 to "
                         "export_model")
    gt = ctx.fresh("gs_grid")
    ctx.emit("Transpose", [grid_nchw], [gt], attrs={"perm": [0, 2, 3, 1]})
    ctx.emit("GridSample", [data, gt], [out],
             attrs={"mode": "bilinear", "padding_mode": "zeros",
                    "align_corners": 1})


@register_converter("BilinearSampler")
def _bilinear_sampler_conv(ctx, s, ins, out):
    _emit_grid_sample(ctx, ins[0], ins[1], out)


def _emit_affine_grid(ctx, theta_name, H, W, hint, out=None):
    """theta (N, 6) → grid (N, 2, H, W): one MatMul against the constant
    homogeneous base grid (the whole GridGenerator as MXU work). Writes to
    ``out`` when given, else a fresh name (returned either way)."""
    ys = np.linspace(-1.0, 1.0, H)
    xs = np.linspace(-1.0, 1.0, W)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    base = np.stack([gx.ravel(), gy.ravel(),
                     np.ones_like(gx).ravel()]).astype(np.float32)
    th = ctx.fresh("%s_theta" % hint)
    ctx.emit("Reshape", [theta_name, ctx.const(
        "tshape", np.asarray([0, 2, 3], np.int64))], [th])
    mm = ctx.fresh("%s_mm" % hint)
    ctx.emit("MatMul", [th, ctx.const("base", base)], [mm])
    grid = out or ctx.fresh("%s_grid" % hint)
    ctx.emit("Reshape", [mm, ctx.const(
        "gshape", np.asarray([0, 2, H, W], np.int64))], [grid])
    return grid


@register_converter("GridGenerator")
def _grid_generator_conv(ctx, s, ins, out):
    a = s._attrs
    tt = a.get("transform_type", "affine")
    if tt == "affine":
        H, W = a["target_shape"]
        _emit_affine_grid(ctx, ins[0], int(H), int(W), "gg", out=out)
        return
    if tt != "warp":
        raise ValueError("GridGenerator export: transform_type %r" % tt)
    # warp: ((flow + identity_pixel_grid) * 2/(dim-1)) - 1
    shape = s._inputs[0].shape      # (N, 2, H, W)
    H, W = int(shape[2]), int(shape[3])
    gy, gx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    ident = ctx.const("ident", np.stack([gx, gy])[None])       # (1,2,H,W)
    scale = ctx.const("scale", np.asarray(
        [2.0 / max(W - 1, 1), 2.0 / max(H - 1, 1)],
        np.float32).reshape(1, 2, 1, 1))
    sm = ctx.fresh("gg_sum")
    ctx.emit("Add", [ins[0], ident], [sm])
    sc = ctx.fresh("gg_scaled")
    ctx.emit("Mul", [sm, scale], [sc])
    one = ctx.const("one", np.float32(1.0))
    ctx.emit("Sub", [sc, one], [out])


@register_converter("SpatialTransformer")
def _spatial_transformer_conv(ctx, s, ins, out):
    a = s._attrs
    if a.get("transform_type", "affine") != "affine":
        raise ValueError("SpatialTransformer export: affine only")
    tshape = a.get("target_shape") or s._inputs[0].shape[2:]
    H, W = int(tshape[0]), int(tshape[1])
    grid = _emit_affine_grid(ctx, ins[1], H, W, "st")
    _emit_grid_sample(ctx, ins[0], grid, out)


# ---- Module-era output heads: inference semantics (the label input and
# grad_scale only shape the backward, which ONNX doesn't carry)
@register_converter("SoftmaxOutput")
def _softmax_output_conv(ctx, s, ins, out):
    # matches the registry kernel exactly (ops/functional.py SoftmaxOutput:
    # softmax over the LAST axis regardless of multi_output)
    ctx.emit("Softmax", ins[:1], [out], attrs={"axis": -1})


@register_converter("LogisticRegressionOutput")
def _logistic_output_conv(ctx, s, ins, out):
    ctx.emit("Sigmoid", ins[:1], [out])


def _fwd_identity_conv(ctx, s, ins, out):
    ctx.emit("Identity", ins[:1], [out])


for _nm in ("LinearRegressionOutput", "MAERegressionOutput", "MakeLoss",
            "SVMOutput", "IdentityAttachKLSparseReg"):
    register_converter(_nm)(_fwd_identity_conv)


@register_converter("ROIAlign")
def _roi_align_conv(ctx, s, ins, out):
    """rois are (R, 5) [batch_idx, x1, y1, x2, y2] — split into ONNX
    RoiAlign's (rois (R,4), batch_indices (R,)) pair."""
    a = s._attrs
    ph, pw = a["pooled_size"]
    bcol = _slice_emit(ctx, ins[1], 0, 1, 1, "ra_bidx")
    bi = ctx.fresh("ra_bi")
    ctx.emit("Cast", [bcol], [bi], attrs={"to": 7})
    bsq = ctx.fresh("ra_bsq")
    ctx.emit("Squeeze", [bi, ctx.const("ax1", np.asarray([1], np.int64))],
             [bsq])
    boxes = _slice_emit(ctx, ins[1], 1, 5, 1, "ra_boxes")
    attrs = {"output_height": int(ph), "output_width": int(pw),
             "spatial_scale": float(a.get("spatial_scale", 1.0)),
             "sampling_ratio": int(a.get("sample_ratio", 2)),
             "mode": "avg"}
    if ctx.opset >= 16:
        # our _roi_grid samples WITHOUT the -0.5 pixel-center offset — that
        # is opset-16's 'output_half_pixel' (the legacy behavior); the
        # opset-16 default is 'half_pixel', so it must be spelled out
        attrs["coordinate_transformation_mode"] = "output_half_pixel"
    ctx.emit("RoiAlign", [ins[0], boxes, bsq], [out], attrs=attrs)


def _seq_len_mask(ctx, s, ins, T, trailing_rank):
    """(T, N) bool mask: position t is valid iff t < sequence_length[n],
    unsqueezed over `trailing_rank` extra dims."""
    rng = ctx.fresh("seq_range")
    ctx.emit("Range", [ctx.const("r0", np.asarray(0, np.float32)),
                       ctx.const("rT", np.asarray(T, np.float32)),
                       ctx.const("r1", np.asarray(1, np.float32))], [rng])
    rcol = ctx.fresh("seq_rcol")
    ctx.emit("Unsqueeze", [rng, ctx.const("ax1", np.asarray([1], np.int64))],
             [rcol])                                   # (T, 1)
    cmp = ctx.fresh("seq_valid")
    ctx.emit("Less", [rcol, ins[1]], [cmp])            # (T, N) via broadcast
    for _ in range(trailing_rank):
        nxt = ctx.fresh("seq_valid_u")
        ctx.emit("Unsqueeze", [cmp, ctx.const(
            "axm1", np.asarray([-1], np.int64))], [nxt])
        cmp = nxt
    return cmp


@register_converter("SequenceMask")
def _sequence_mask_conv(ctx, s, ins, out):
    a = s._attrs
    if not a.get("use_sequence_length", False):
        ctx.emit("Identity", ins[:1], [out])
        return
    if int(a.get("axis", 0)) != 0:
        raise ValueError("SequenceMask export: only axis=0 (time-major)")
    shape = s._inputs[0].shape
    valid = _seq_len_mask(ctx, s, ins, shape[0], len(shape) - 2)
    val = ctx.const("maskval", np.float32(a.get("value", 0.0)))
    ctx.emit("Where", [valid, ins[0], val], [out])


@register_converter("SequenceLast")
def _sequence_last_conv(ctx, s, ins, out):
    a = s._attrs
    if int(a.get("axis", 0)) != 0:
        raise ValueError("SequenceLast export: only axis=0 (time-major)")
    shape = s._inputs[0].shape
    if not a.get("use_sequence_length", False):
        ctx.emit("Gather", [ins[0], ctx.const(
            "lastidx", np.asarray(shape[0] - 1, np.int64))], [out],
            attrs={"axis": 0})
        return
    # per-example last valid step: GatherND with indices [(len[n]-1, n)]
    li = ctx.fresh("sl_lastpos")
    ctx.emit("Sub", [ins[1], ctx.const("one", np.float32(1.0))], [li])
    lii = ctx.fresh("sl_lastpos_i")
    ctx.emit("Cast", [li], [lii], attrs={"to": 7})
    lcol = ctx.fresh("sl_lcol")
    ctx.emit("Unsqueeze", [lii, ctx.const("ax1b",
                                          np.asarray([1], np.int64))], [lcol])
    nrng = ctx.fresh("sl_nrange")
    ctx.emit("Range", [ctx.const("n0", np.asarray(0, np.int64)),
                       ctx.const("nN", np.asarray(shape[1], np.int64)),
                       ctx.const("n1", np.asarray(1, np.int64))], [nrng])
    ncol = ctx.fresh("sl_ncol")
    ctx.emit("Unsqueeze", [nrng, ctx.const("ax1c",
                                           np.asarray([1], np.int64))], [ncol])
    idx = ctx.fresh("sl_idx")
    ctx.emit("Concat", [lcol, ncol], [idx], attrs={"axis": 1})   # (N, 2)
    ctx.emit("GatherND", [ins[0], idx], [out])


@register_converter("SequenceReverse")
def _sequence_reverse_conv(ctx, s, ins, out):
    a = s._attrs
    if a.get("use_sequence_length", False):
        raise ValueError("SequenceReverse export: per-example lengths do "
                         "not map to a fixed ONNX node set")
    if int(a.get("axis", 0)) != 0:
        raise ValueError("SequenceReverse export: only axis=0")
    imax = np.iinfo(np.int64).max
    ctx.emit("Slice", [ins[0],
                       ctx.const("starts", np.asarray([-1], np.int64)),
                       ctx.const("ends", np.asarray([-imax], np.int64)),
                       ctx.const("axes", np.asarray([0], np.int64)),
                       ctx.const("steps", np.asarray([-1], np.int64))], [out])


@register_converter("masked_softmax")
def _masked_softmax_conv(ctx, s, ins, out):
    axis = int(s._attrs.get("axis", -1))
    if len(ins) < 2:
        ctx.emit("Softmax", ins[:1], [out], attrs={"axis": axis})
        return
    # matches the registry op exactly: softmax(where(mask, x, -1e30)) with
    # NO re-zeroing (a fully-masked row yields uniform 1/n, not zeros)
    mb = ctx.fresh("msm_bool")
    ctx.emit("Cast", [ins[1]], [mb], attrs={"to": int(P.BOOL)})
    neg = ctx.const("msm_neg", np.float32(-1e30))
    masked = ctx.fresh("msm_masked")
    ctx.emit("Where", [mb, ins[0], neg], [masked])
    ctx.emit("Softmax", [masked], [out], attrs={"axis": axis})


@register_converter("broadcast_like")
def _broadcast_like_conv(ctx, s, ins, out):
    shp = ctx.fresh("bl_shape")
    ctx.emit("Shape", [ins[1]], [shp])
    ctx.emit("Expand", [ins[0], shp], [out])


@register_converter("broadcast_axis")
def _broadcast_axis_conv(ctx, s, ins, out):
    a = s._attrs
    shape = list(s._inputs[0].shape)
    axes = a["axis"] if isinstance(a["axis"], (tuple, list)) else [a["axis"]]
    sizes = a["size"] if isinstance(a["size"], (tuple, list)) else [a["size"]]
    for ax, sz in zip(axes, sizes):
        shape[ax] = int(sz)
    ctx.emit("Expand", [ins[0], ctx.const(
        "target", np.asarray(shape, np.int64))], [out])


register_converter("broadcast_axes")(_CONVERTERS["broadcast_axis"])


@register_converter("Pad")
def _pad_legacy_conv(ctx, s, ins, out):
    a = s._attrs
    pw = a.get("pad_width")
    if pw is None:
        raise ValueError("Pad export needs pad_width")
    nd = len(pw) // 2
    begins = [int(pw[2 * i]) for i in range(nd)]
    ends = [int(pw[2 * i + 1]) for i in range(nd)]
    mode = {"constant": "constant", "edge": "edge",
            "reflect": "reflect"}[a.get("mode", "constant")]
    node_in = [ins[0], ctx.const("pads", np.asarray(begins + ends, np.int64))]
    if mode == "constant":
        node_in.append(ctx.const("padval",
                                 np.float32(a.get("constant_value", 0.0))))
    ctx.emit("Pad", node_in, [out], attrs={"mode": mode})


@register_converter("argsort")
def _argsort_conv(ctx, s, ins, out):
    a = s._attrs
    axis = int(a.get("axis", -1))
    shape = s._inputs[0].shape
    k = ctx.const("k", np.asarray([shape[axis]], np.int64))
    vals = ctx.fresh("argsort_vals")
    idx = ctx.fresh("argsort_idx")
    ctx.emit("TopK", [ins[0], k], [vals, idx],
             attrs={"axis": axis, "largest": 0 if a.get("is_ascend", True)
                    else 1, "sorted": 1})
    code = P.np_to_onnx_dtype(_np_dtype(a.get("dtype", "float32")))
    ctx.emit("Cast", [idx], [out], attrs={"to": int(code)})


@register_converter("argmax_channel")
def _argmax_channel_conv(ctx, s, ins, out):
    r = ctx.fresh("amc")
    ctx.emit("ArgMax", ins[:1], [r], attrs={"axis": 1, "keepdims": 0})
    ctx.emit("Cast", [r], [out], attrs={"to": int(P.FLOAT)})


@register_converter("GroupNorm")
def _group_norm_conv(ctx, s, ins, out):
    """Exact decomposition over standard nodes (opset 13 has no
    GroupNormalization): reshape to (N, G, rest), normalize over rest with
    the op's own eps, reshape back, per-channel affine."""
    a = s._attrs
    G = int(a.get("num_groups", 1))
    eps = float(a.get("eps", 1e-5))
    shape = s._inputs[0].shape  # meta-tensor shape inference through the graph
    C = shape[1]
    xg = ctx.fresh("gn_grouped")
    ctx.emit("Reshape", [ins[0], ctx.const(
        "gshape", np.asarray([shape[0], G, -1], np.int64))], [xg])
    m = ctx.fresh("gn_mean")
    ctx.emit("ReduceMean", [xg], [m], attrs={"axes": [2], "keepdims": 1})
    d = ctx.fresh("gn_dev")
    ctx.emit("Sub", [xg, m], [d])
    d2 = ctx.fresh("gn_dev2")
    ctx.emit("Mul", [d, d], [d2])
    v = ctx.fresh("gn_var")
    ctx.emit("ReduceMean", [d2], [v], attrs={"axes": [2], "keepdims": 1})
    ve = ctx.fresh("gn_vareps")
    ctx.emit("Add", [v, ctx.const("eps", np.float32(eps))], [ve])
    sd = ctx.fresh("gn_std")
    ctx.emit("Sqrt", [ve], [sd])
    yn = ctx.fresh("gn_norm")
    ctx.emit("Div", [d, sd], [yn])
    yr = ctx.fresh("gn_back")
    ctx.emit("Reshape", [yn, ctx.const(
        "xshape", np.asarray(shape, np.int64))], [yr])
    cshape = ctx.const("cshape",
                       np.asarray([1, C] + [1] * (len(shape) - 2), np.int64))
    gr = ctx.fresh("gn_gamma")
    ctx.emit("Reshape", [ins[1], cshape], [gr])
    br = ctx.fresh("gn_beta")
    ctx.emit("Reshape", [ins[2], cshape], [br])
    sc = ctx.fresh("gn_scaled")
    ctx.emit("Mul", [yr, gr], [sc])
    ctx.emit("Add", [sc, br], [out])


@register_converter("UpSampling")
def _upsampling_conv(ctx, s, ins, out):
    a = s._attrs
    scale = float(a.get("scale", 2))
    scales = ctx.const("scales", np.asarray([1.0, 1.0, scale, scale],
                                            np.float32))
    if a.get("sample_type", "nearest") == "nearest":
        # repeat_interleave == asymmetric coords + floor nearest rounding
        attrs = {"mode": "nearest",
                 "coordinate_transformation_mode": "asymmetric",
                 "nearest_mode": "floor"}
    else:
        attrs = {"mode": "linear",
                 "coordinate_transformation_mode": "half_pixel"}
    ctx.emit("Resize", [ins[0], "", scales], [out], attrs=attrs)


def _emit_linear_resize(ctx, s, ins, out, ctm):
    a = s._attrs
    attrs = {"mode": "linear", "coordinate_transformation_mode": ctm}
    if a.get("height") is not None:
        n, c = s._inputs[0].shape[:2]
        sizes = ctx.const("sizes", np.asarray(
            [n, c, int(a["height"]), int(a["width"])], np.int64))
        ctx.emit("Resize", [ins[0], "", "", sizes], [out], attrs=attrs)
    else:
        scales = ctx.const("scales", np.asarray(
            [1.0, 1.0, float(a["scale_height"]), float(a["scale_width"])],
            np.float32))
        ctx.emit("Resize", [ins[0], "", scales], [out], attrs=attrs)


@register_converter("AdaptiveAvgPooling2D")
def _adaptive_avg_pool_conv(ctx, s, ins, out):
    """output_size (1,1) → GlobalAveragePool; anything else exports the op's
    exact two-matmul form (ops/functional.py:AdaptiveAvgPooling2D): L·x·R
    with the static averaging matrices as initializers — bit-identical to
    the registry op, expressible in plain ONNX (no AdaptiveAvgPool exists
    in the spec)."""
    size = s._attrs.get("output_size")
    h, w = s._inputs[0].shape[2], s._inputs[0].shape[3]
    if size is None or size == ():
        oh, ow = h, w
    elif isinstance(size, (tuple, list)):
        oh, ow = int(size[0]), int(size[1 if len(size) > 1 else 0])
    else:
        oh = ow = int(size)
    if (oh, ow) == (1, 1):
        ctx.emit("GlobalAveragePool", [ins[0]], [out])
        return
    if (oh, ow) == (h, w):
        ctx.emit("Identity", [ins[0]], [out])
        return
    from ..ops.functional import adaptive_avg_matrix

    left = ctx.const("adaptL", adaptive_avg_matrix(h, oh))    # (oh, h)
    right = ctx.const("adaptR", adaptive_avg_matrix(w, ow).T)  # (w, ow)
    rows = ctx.fresh("rows")
    ctx.emit("MatMul", [left, ins[0]], [rows])          # (B, C, oh, w)
    ctx.emit("MatMul", [rows, right], [out])            # (B, C, oh, ow)


@register_converter("BilinearResize2D")
def _bilinear_resize_conv(ctx, s, ins, out):
    _emit_linear_resize(ctx, s, ins, out, "align_corners")


@register_converter("_resize_linear_asymmetric")
def _resize_asymmetric_conv(ctx, s, ins, out):
    _emit_linear_resize(ctx, s, ins, out, "asymmetric")


@register_converter("_resize_linear_half_pixel")
def _resize_half_pixel_conv(ctx, s, ins, out):
    # preserve the ctm the op was imported with: half_pixel and
    # pytorch_half_pixel diverge when an output spatial dim is 1
    # (ops/functional.py:929), so rewriting one as the other on re-export
    # would change what onnxruntime computes
    ctm = ("pytorch_half_pixel" if s._attrs.get("pytorch_mode")
           else "half_pixel")
    _emit_linear_resize(ctx, s, ins, out, ctm)


def _slice_emit(ctx, src, start, end, axis, hint):
    out = ctx.fresh(hint)
    ctx.emit("Slice", [src,
                       ctx.const("starts", np.asarray([start], np.int64)),
                       ctx.const("ends", np.asarray([end], np.int64)),
                       ctx.const("axes", np.asarray([axis], np.int64))], [out])
    return out


@register_converter("box_nms")
def _box_nms_conv(ctx, s, ins, out):
    """box_nms → NonMaxSuppression + gather/scatter reconstruction.

    MXNet box_nms keeps boxes in place and sets suppressed SCORES to -1
    (src/operator/contrib/bounding_box.cc), so the ONNX form is: NMS selects
    surviving (batch, box) pairs; a -1-filled score plane is ScatterND-ed
    with the surviving scores; ids/boxes columns pass through unchanged."""
    a = s._attrs
    if (a.get("coord_start", 2) != 2 or a.get("score_index", 1) != 1
            or a.get("in_format", "corner") != "corner"):
        raise ValueError("box_nms export supports the standard "
                         "[id, score, x1,y1,x2,y2] corner layout only")
    id_index = a.get("id_index", 0)
    if id_index >= 0 and not a.get("force_suppress", False):
        raise ValueError(
            "box_nms export: per-class suppression (id_index>=0, "
            "force_suppress=False) cannot map to ONNX NMS, whose classes "
            "are a static scores axis — use force_suppress=True or "
            "id_index=-1")
    in_shape = s._inputs[0].shape
    if len(in_shape) != 3 or in_shape[-1] != 6:
        raise ValueError(
            "box_nms export supports (B, N, 6) data only, got %r — extra "
            "label columns or 2-D inputs would be silently dropped"
            % (in_shape,))
    data = ins[0]
    N = in_shape[-2]
    topk = int(a.get("topk", -1))
    ids = _slice_emit(ctx, data, 0, 1, 2, "nms_ids")             # (B,N,1)
    scores3 = _slice_emit(ctx, data, 1, 2, 2, "nms_scores")      # (B,N,1)
    boxes = _slice_emit(ctx, data, 2, 6, 2, "nms_boxes")         # (B,N,4)
    scoresT = ctx.fresh("nms_scoresT")
    ctx.emit("Transpose", [scores3], [scoresT], attrs={"perm": [0, 2, 1]})
    sel = ctx.fresh("nms_sel")
    ctx.emit("NonMaxSuppression",
             [boxes, scoresT,
              ctx.const("max_out", np.asarray(
                  [topk if topk > 0 else N], np.int64)),
              ctx.const("iou", np.asarray(
                  [float(a.get("overlap_thresh", 0.5))], np.float32)),
              ctx.const("score_th", np.asarray(
                  [float(a.get("valid_thresh", 0.0))], np.float32))],
             [sel])                                              # (M,3)
    bcol = _slice_emit(ctx, sel, 0, 1, 1, "nms_bi")
    icol = _slice_emit(ctx, sel, 2, 3, 1, "nms_box_i")
    idx2 = ctx.fresh("nms_idx2")
    ctx.emit("Concat", [bcol, icol], [idx2], attrs={"axis": 1})  # (M,2)
    scores2 = ctx.fresh("nms_scores2")
    ctx.emit("Squeeze", [scores3, ctx.const("axes",
                                            np.asarray([2], np.int64))],
             [scores2])                                          # (B,N)
    kept = ctx.fresh("nms_kept")
    ctx.emit("GatherND", [scores2, idx2], [kept])                # (M,)
    z = ctx.fresh("nms_zero")
    ctx.emit("Mul", [scores2, ctx.const("zero", np.float32(0.0))], [z])
    neg = ctx.fresh("nms_neg")
    ctx.emit("Add", [z, ctx.const("negone", np.float32(-1.0))], [neg])
    new2 = ctx.fresh("nms_new2")
    ctx.emit("ScatterND", [neg, idx2, kept], [new2])             # (B,N)
    new3 = ctx.fresh("nms_new3")
    ctx.emit("Unsqueeze", [new2, ctx.const("axes",
                                           np.asarray([2], np.int64))],
             [new3])
    ctx.emit("Concat", [ids, new3, boxes], [out], attrs={"axis": 2})


@register_converter("_onnx_nms")
def _onnx_nms_conv(ctx, s, ins, out):
    a = s._attrs
    # our op treats max_output=0 as "keep all" (K=N); ONNX spec reads a
    # literal 0 as "select nothing", so absent/0 exports as the box count
    max_out = int(a.get("max_output_boxes_per_class", 0))
    if max_out <= 0:
        max_out = int(s._inputs[0].shape[-2])
    node_in = [ins[0], ins[1],
               ctx.const("max_out", np.asarray([max_out], np.int64)),
               ctx.const("iou", np.asarray(
                   [float(a.get("iou_threshold", 0.0))], np.float32))]
    if a.get("score_threshold") is not None:
        # absent means "no filtering" — omit the optional input rather than
        # writing 0.0, which would newly drop negative-score boxes
        node_in.append(ctx.const("score_th", np.asarray(
            [float(a["score_threshold"])], np.float32)))
    ctx.emit("NonMaxSuppression", node_in, [out],
             attrs={"center_point_box": int(a.get("center_point_box", 0))})


@register_converter("_onnx_gather_nd")
def _onnx_gather_nd_conv(ctx, s, ins, out):
    ctx.emit("GatherND", ins[:2], [out])


@register_converter("_onnx_scatter_nd")
def _onnx_scatter_nd_conv(ctx, s, ins, out):
    ctx.emit("ScatterND", ins[:3], [out])


# ------------------------------------------------------------ recurrent ops

# MXNet gate order: LSTM [i, f, g, o], GRU [r, z, n] (src/operator/rnn-inl.h).
# ONNX gate order:  LSTM [i, o, f, c], GRU [z, r, h].
_LSTM_TO_ONNX = [0, 3, 1, 2]
_GRU_TO_ONNX = [1, 0, 2]
_LSTM_FROM_ONNX = [0, 2, 3, 1]
_GRU_FROM_ONNX = [1, 0, 2]


def _gate_perm(arr, perm, hidden):
    g = len(perm)
    return np.ascontiguousarray(
        arr.reshape((g, hidden) + arr.shape[1:])[perm].reshape(arr.shape))


@register_converter("RNN")
def _rnn_conv(ctx, s, ins, out):
    """Fused multi-layer RNN → one ONNX LSTM/GRU/RNN node per layer
    (ONNX recurrent ops are single-layer; num_directions is the only stacking
    they support). Weight initializers are re-blocked to ONNX gate order."""
    a = s._attrs
    mode = a.get("mode", "lstm")
    L = int(a.get("num_layers", 1))
    D = 2 if a.get("bidirectional") else 1
    onnx_op = {"lstm": "LSTM", "gru": "GRU"}.get(mode, "RNN")
    perm = {"lstm": _LSTM_TO_ONNX, "gru": _GRU_TO_ONNX}.get(mode, [0])

    def arr_of(name):
        if name not in ctx.initializers:
            raise ValueError("RNN export: weight %r must be a parameter" % name)
        return np.asarray(ctx.initializers[name], np.float32)

    def state_slice(state_name, layer, hint):
        sl = ctx.fresh(hint)
        ctx.emit("Slice", [state_name,
                           ctx.const("starts", np.asarray([layer * D], np.int64)),
                           ctx.const("ends", np.asarray([(layer + 1) * D], np.int64)),
                           ctx.const("axes", np.asarray([0], np.int64))], [sl])
        return sl

    cur = ins[0]
    wnames = ins[3:]
    hs, cs = [], []
    wi = 0
    for layer in range(L):
        Ws, Rs, Bs = [], [], []
        H = None
        for _ in range(D):
            wih, whh, bih, bhh = (arr_of(wnames[wi + k]) for k in range(4))
            wi += 4
            H = whh.shape[1]
            Ws.append(_gate_perm(wih, perm, H))
            Rs.append(_gate_perm(whh, perm, H))
            Bs.append(np.concatenate([_gate_perm(bih, perm, H),
                                      _gate_perm(bhh, perm, H)]))
        W = ctx.const("rnn_W", np.stack(Ws))
        R = ctx.const("rnn_R", np.stack(Rs))
        B = ctx.const("rnn_B", np.stack(Bs))
        node_in = [cur, W, R, B, "", state_slice(ins[1], layer, "rnn_h0")]
        if mode == "lstm":
            node_in.append(state_slice(ins[2], layer, "rnn_c0"))
        attrs = {"hidden_size": H,
                 "direction": "bidirectional" if D == 2 else "forward"}
        if mode == "gru":
            # our GRU applies reset AFTER the recurrent matmul+bias
            attrs["linear_before_reset"] = 1
        if onnx_op == "RNN":
            attrs["activations"] = ["Tanh" if mode == "rnn_tanh" else "Relu"] * D
        y = ctx.fresh("rnn_Y")
        yh = ctx.fresh("rnn_Yh")
        outs = [y, yh]
        if mode == "lstm":
            yc = ctx.fresh("rnn_Yc")
            outs.append(yc)
            cs.append(yc)
        ctx.emit(onnx_op, node_in, outs, attrs=attrs)
        hs.append(yh)
        # Y (T, D, N, H) → next layer's X (T, N, D*H)
        tr = ctx.fresh("rnn_tr")
        ctx.emit("Transpose", [y], [tr], attrs={"perm": [0, 2, 1, 3]})
        rs = ctx.fresh("rnn_seq")
        ctx.emit("Reshape", [tr, ctx.const("shape",
                                           np.asarray([0, 0, -1], np.int64))],
                 [rs])
        cur = rs

    def stack_states(names, hint):
        if len(names) == 1:
            return names[0]
        cat = ctx.fresh(hint)
        ctx.emit("Concat", names, [cat], attrs={"axis": 0})
        return cat

    h_out = stack_states(hs, "rnn_hn")
    # non-LSTM modes pass the input cell state through untouched
    # (ops/rnn.py returns c0) — mirror that, not hn
    c_out = stack_states(cs, "rnn_cn") if mode == "lstm" else ins[2]
    ctx.multi[id(s)] = [cur, h_out, c_out]
    ctx.names[id(s)] = cur
    return cur


@register_converter("_cond")
def _cond_conv(ctx, s, ins, out):
    """symbol.cond → ONNX If. Branch subgraphs reference outer-scope values
    by name (ONNX scoping) — the branch var symbols ARE the outer graph
    symbols, so their names are already assigned in ctx.names."""
    a = s._attrs
    pred = ctx.fresh("cond_pred")
    ctx.emit("Cast", [ins[0]], [pred], attrs={"to": int(P.BOOL)})

    # names assigned before this node belong to the OUTER scope; anything a
    # branch adds (including nodes shared between the two branches) must be
    # re-emitted per branch — ONNX subgraphs can see outer names but never a
    # sibling subgraph's internals
    outer_names = dict(ctx.names)
    outer_multi = dict(ctx.multi)

    def branch_graph(branch_sym, tag):
        saved = ctx.nodes
        ctx.nodes = []
        ctx.names = dict(outer_names)
        ctx.multi = dict(outer_multi)
        order = _toposort([branch_sym])
        for node in order:
            if node.is_var():
                if id(node) not in ctx.names:
                    raise ValueError("If export: branch var %r not in outer "
                                     "scope" % node.name)
                continue
            if id(node) in ctx.names:
                continue  # emitted in the outer graph, visible by scoping
            _convert_node(ctx, node)
        bout = ctx.names[id(branch_sym)]
        nodes = ctx.nodes
        ctx.nodes = saved
        g = P.graph_proto("%s_%s" % (s.name, tag), nodes, [],
                          [P.value_info(bout, np.float32, ())], [])
        return P.GraphAttr(g)

    try:
        then_attr = branch_graph(a["then_sym"], "then")
        else_attr = branch_graph(a["else_sym"], "else")
    finally:
        ctx.names = outer_names
        ctx.multi = outer_multi
    ctx.names[id(s)] = out

    ctx.emit("If", [pred], [out],
             attrs={"then_branch": then_attr, "else_branch": else_attr})


@register_converter("_foreach")
def _foreach_conv(ctx, s, ins, out):
    """symbol.foreach → ONNX Scan (the exact semantic match: per-step state
    threading + stacked scan outputs). Body formal inputs are [states...,
    scan slice]; free variables resolve through ONNX outer-scope naming."""
    a = s._attrs
    n_states = a["n_states"]
    roots = list(a["state_syms"]) + [a["out_sym"]]  # Scan output order

    # the loop-var Symbols ARE the body's formal inputs — find them by name
    loop_names = [a["slice_name"]] + list(a["state_names"])
    var_syms = {}
    for root in roots:
        for arg in root._arg_symbols():
            if arg.name in loop_names:
                var_syms[arg.name] = arg

    outer_names = dict(ctx.names)
    outer_multi = dict(ctx.multi)
    saved_nodes = ctx.nodes
    ctx.nodes = []
    ctx.names = dict(outer_names)
    ctx.multi = dict(outer_multi)
    try:
        input_vis = []
        for nm in list(a["state_names"]) + [a["slice_name"]]:
            if nm in var_syms:
                ctx.names[id(var_syms[nm])] = nm
            input_vis.append(P.value_info(nm, np.float32, ()))
        for node_ in _toposort(roots):
            if node_.is_var():
                if id(node_) not in ctx.names:
                    raise ValueError("Scan export: body var %r not in outer "
                                     "scope" % node_.name)
                continue
            if id(node_) in ctx.names:
                continue  # outer-scope value, visible by ONNX scoping
            _convert_node(ctx, node_)
        # graph output names must be UNIQUE: the idiomatic `return h, h`
        # body reuses one Symbol for output and state — alias repeats
        # through Identity nodes
        out_names, used = [], set()
        for r in roots:
            nm = ctx.names[id(r)]
            if nm in used:
                alias = ctx.fresh("%s_alias" % nm)
                ctx.emit("Identity", [nm], [alias])
                nm = alias
            used.add(nm)
            out_names.append(nm)
        out_vis = [P.value_info(nm, np.float32, ()) for nm in out_names]
        body = P.GraphAttr(P.graph_proto("%s_body" % s.name, ctx.nodes,
                                         input_vis, out_vis, []))
    finally:
        ctx.nodes = saved_nodes
        ctx.names = outer_names
        ctx.multi = outer_multi

    # Scan node: inputs [initial_states..., scan_input]; outputs
    # [final_states..., stacked_scan_output]
    node_inputs = [ins[1 + i] for i in range(n_states)] + [ins[0]]
    final_states = [ctx.fresh("scan_state%d" % i) for i in range(n_states)]
    ctx.emit("Scan", node_inputs, final_states + [out],
             attrs={"body": body, "num_scan_inputs": 1})
    # our _item order is [stacked_outputs, states...]
    ctx.multi[id(s)] = [out] + final_states
    ctx.names[id(s)] = out
    return out


@register_converter("_while")
def _while_conv(ctx, s, ins, out):
    """symbol while_loop → ONNX Loop. Body formals are [iter, cond_in,
    vars...]; the body emits [cond_out, new_vars..., per-step output], with
    cond_out re-evaluating the predicate on the NEW vars (ONNX's cond is
    produced by the body for the next iteration, where our masked scan
    evaluates it before each step — same executed-iteration set). The
    initial cond is the predicate over the initial values, emitted in the
    outer graph. Static-shape deviation: our executor always stacks
    max_iterations rows (masked steps emit zeros); a spec runtime stacks
    only executed rows.
    """
    a = s._attrs
    n_vars = a["n_vars"]
    var_names = list(a["var_names"])
    pred_sym = a["pred_sym"]
    roots = [pred_sym, a["out_sym"]] + list(a["var_syms"])

    var_syms = {}
    for root in roots:
        for arg in root._arg_symbols():
            if arg.name in var_names:
                var_syms[arg.name] = arg

    def _convert_scoped(root_list, bindings):
        """Convert symbols with loop-var ids bound to given value names;
        conversion cache starts from the OUTER names only, so the same
        subgraph can be re-emitted against different bindings."""
        ctx.names = dict(outer_names)
        ctx.multi = dict(outer_multi)
        for nm, val in bindings.items():
            if nm in var_syms:
                ctx.names[id(var_syms[nm])] = val
        for node_ in _toposort(root_list):
            if node_.is_var():
                if id(node_) not in ctx.names:
                    raise ValueError("Loop export: body var %r not in outer "
                                     "scope" % node_.name)
                continue
            if id(node_) in ctx.names:
                continue
            _convert_node(ctx, node_)
        return [ctx.names[id(r)] for r in root_list]

    outer_names = dict(ctx.names)
    outer_multi = dict(ctx.multi)

    # initial condition: predicate over the Loop node's initial values,
    # evaluated in the OUTER graph
    (cond0,) = _convert_scoped([pred_sym],
                               dict(zip(var_names, ins[:n_vars])))

    iter_nm = ctx.fresh("wl_iter")
    cond_in = ctx.fresh("wl_cond_in")
    saved_nodes = ctx.nodes
    ctx.nodes = []
    try:
        # pass 1: body exprs (out + new vars) on the formal var inputs
        body_roots = [a["out_sym"]] + list(a["var_syms"])
        body_outs = _convert_scoped(body_roots,
                                    dict(zip(var_names, var_names)))
        step_out, new_var_names = body_outs[0], body_outs[1:]
        # pass 2: predicate on the NEW var values (fresh scope: shared
        # subexpressions re-emit rather than alias stale bindings)
        (cond_out,) = _convert_scoped([pred_sym],
                                      dict(zip(var_names, new_var_names)))
        cond_out_b = ctx.fresh("wl_cond_out")
        ctx.emit("Cast", [cond_out], [cond_out_b],
                 attrs={"to": int(P.BOOL)})
        cond_out = cond_out_b

        input_vis = ([P.value_info(iter_nm, np.int64, ()),
                      P.value_info(cond_in, np.bool_, ())]
                     + [P.value_info(nm, np.float32, ()) for nm in var_names])
        out_names, used = [], set()
        for nm in [cond_out] + new_var_names + [step_out]:
            if nm in used:
                alias = ctx.fresh("%s_alias" % nm)
                ctx.emit("Identity", [nm], [alias])
                nm = alias
            used.add(nm)
            out_names.append(nm)
        out_vis = [P.value_info(nm, np.float32, ()) for nm in out_names]
        body = P.GraphAttr(P.graph_proto("%s_body" % s.name, ctx.nodes,
                                         input_vis, out_vis, []))
    finally:
        ctx.nodes = saved_nodes
        ctx.names = dict(outer_names)
        ctx.multi = dict(outer_multi)

    m_name = ctx.const("wl_m", np.asarray(a["max_iterations"], np.int64))
    cond0b = ctx.fresh("wl_cond0")
    ctx.emit("Cast", [cond0], [cond0b], attrs={"to": int(P.BOOL)})
    final_vars = [ctx.fresh("wl_final%d" % i) for i in range(n_vars)]
    ctx.emit("Loop", [m_name, cond0b] + list(ins[:n_vars]),
             final_vars + [out], attrs={"body": body})
    # our _item order is [stacked_outputs, final_vars...]
    ctx.multi[id(s)] = [out] + final_vars
    ctx.names[id(s)] = out
    return out


# ------------------------------------------------------------- graph walker

def _convert_node(ctx, s):
    """Translate one non-var Symbol node, registering its output name(s)."""
    if s._op == "_item":
        # projection of a multi-output op. Converters that emit every
        # output (RNN) fill ctx.multi; otherwise only index 0 exists —
        # consuming a secondary output (e.g. BatchNorm's updated running
        # stats) has no ONNX inference-graph equivalent.
        parent = s._inputs[0]
        idx = s._attrs.get("index", 0)
        multi = ctx.multi.get(id(parent))
        if multi is not None:
            ctx.names[id(s)] = multi[idx]
            return
        if idx != 0:
            raise ValueError(
                "cannot export: graph consumes output %d of %r — only "
                "the primary output of multi-output ops maps to ONNX "
                "inference graphs" % (idx, parent._op))
        ctx.names[id(s)] = ctx.names[id(parent)]
        return
    ins = [ctx.names[id(i)] for i in s._inputs]
    out = ctx.fresh(s.name or s._op)
    ctx.names[id(s)] = out
    conv = _CONVERTERS.get(s._op)
    if conv is None:
        raise ValueError("no ONNX converter for op %r (export coverage "
                         "mirrors mx2onnx/_op_translations)" % s._op)
    conv(ctx, s, ins, out)


def _toposort(outputs):
    order, seen = [], set()

    def walk(s):
        if id(s) in seen:
            return
        seen.add(id(s))
        for i in s._inputs:
            walk(i)
        order.append(s)

    for o in outputs:
        walk(o)
    return order


def symbol_to_onnx(sym_out, params, input_shapes, input_dtypes=None,
                   graph_name="mxnet_tpu", opset=13):
    """Convert a Symbol graph (single output or Group) to ModelProto bytes.

    params: {name: np.ndarray} for every non-data variable in the graph.
    input_shapes: {data_name: shape} for graph inputs.
    """
    outputs = sym_out._inputs if sym_out._op == "_group" else [sym_out]
    order = _toposort(outputs)
    ctx = _Ctx(params, opset)
    input_dtypes = input_dtypes or {}

    # name variables; params become initializers, the rest graph inputs.
    # Every var gets its static shape so converters needing shapes (RNN
    # inter-layer reshapes, multibox_prior constant-folding) can query
    # Symbol.shape (meta-tensor inference through the graph).
    graph_inputs = []
    for s in order:
        if not s.is_var():
            continue
        ctx.names[id(s)] = s.name
        if s.name in params:
            ctx.initializers[s.name] = np.asarray(params[s.name])
            if s._shape is None:
                s._shape = tuple(np.asarray(params[s.name]).shape)
        else:
            if s.name not in input_shapes:
                raise ValueError("no shape for graph input %r" % s.name)
            if s._shape is None:
                s._shape = tuple(input_shapes[s.name])
            graph_inputs.append(
                P.value_info(s.name, input_dtypes.get(s.name, np.float32),
                             input_shapes[s.name]))

    for s in order:
        if s.is_var():
            continue
        _convert_node(ctx, s)

    out_infos = [P.value_info(ctx.names[id(o)], np.float32, ())
                 for o in outputs]
    init_protos = [P.tensor_proto(n, a) for n, a in ctx.initializers.items()]
    graph = P.graph_proto(graph_name, ctx.nodes, graph_inputs, out_infos,
                          init_protos)
    return P.model_proto(graph, opset=opset).tobytes()


def _to_numpy(v):
    """A parameter's values as numpy: an NDArray or a tensor on any
    device (bfloat16 as ``ml_dtypes.bfloat16`` where installed, else
    float32, which holds it exactly)."""
    import torch

    if hasattr(v, "_tensor"):
        v = v._tensor()
    elif hasattr(v, "asnumpy") and not isinstance(v, torch.Tensor):
        return np.asarray(v.asnumpy())
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            dt = P._bf16_dtype()
            if dt.itemsize == 2:
                return t.view(torch.int16).numpy().view(dt)
            t = t.float()
        return t.numpy()
    return np.asarray(v)


def export_model(model, params=None, input_shapes=None, input_types=None,
                 onnx_file=None, input_names=("data",), opset=13):
    """Export a HybridBlock or Symbol to an ONNX file
    (ref: python/mxnet/onnx/mx2onnx/_export_model.py:export_model).

    * HybridBlock: traced via block(sym.var(name) for each input_name);
      parameters are pulled from collect_params().
    * Symbol: ``params`` must map var name → array.
    Returns the path written (or the serialized bytes if onnx_file is None).
    """
    from .. import sym as _sym

    if input_shapes is None:
        raise ValueError("input_shapes is required")
    if not isinstance(input_shapes, dict):
        input_shapes = dict(zip(input_names, [tuple(s) for s in input_shapes]))
    if input_types is not None and not isinstance(input_types, dict):
        # pair by input_names order, NOT the shapes dict's insertion order
        # (a dict-shapes caller may list names in a different order)
        input_types = dict(zip(input_names, input_types))

    if isinstance(model, Symbol):
        sym_out = model
        params = {k: _to_numpy(v) for k, v in (params or {}).items()}
    else:
        # shapes on the trace vars: hybrid_forward code may query x.shape
        # (rnn state sizing, SSD reshape heads)
        data = [_sym.var(n, shape=tuple(input_shapes[n])) for n in input_shapes]
        sym_out = model(*data)
        if isinstance(sym_out, (list, tuple)):
            from ..symbol import Group
            sym_out = Group(list(sym_out))
        params = {p.name: _to_numpy(p._tensor())
                  for p in model.collect_params().values()}

    buf = symbol_to_onnx(sym_out, params, input_shapes,
                         input_dtypes=input_types, opset=opset)
    if onnx_file is None:
        return buf
    with open(onnx_file, "wb") as f:
        f.write(buf)
    return onnx_file


# --------------------------- breadth batch: converters for common ops

def _reg_simple_conv(op, onnx_op):
    @register_converter(op)
    def conv(ctx, s, ins, out, _onnx=onnx_op):
        ctx.emit(_onnx, ins, [out])


_reg_simple_conv("add_n", "Sum")


def _cast(ctx, name, to):
    c = ctx.fresh("cast")
    ctx.emit("Cast", [name], [c], attrs={"to": int(to)})
    return c


@register_converter("where")
def _where_conv(ctx, s, ins, out):
    # mxnet_tpu conditions are float; ONNX Where requires bool
    ctx.emit("Where", [_cast(ctx, ins[0], P.BOOL), ins[1], ins[2]], [out])


def _reg_compare_conv(op, onnx_op):
    @register_converter(op)
    def conv(ctx, s, ins, out, _onnx=onnx_op):
        # comparisons produce bool in ONNX but float in mxnet_tpu — cast
        # inputs for Not, and cast every result back to float
        if _onnx == "Not":
            ins = [_cast(ctx, ins[0], P.BOOL)]
        b = ctx.fresh("cmp")
        ctx.emit(_onnx, ins, [b])
        ctx.emit("Cast", [b], [out], attrs={"to": int(P.FLOAT)})


_reg_compare_conv("broadcast_equal", "Equal")
_reg_compare_conv("broadcast_greater", "Greater")
_reg_compare_conv("broadcast_lesser", "Less")
_reg_compare_conv("logical_not", "Not")


def _flat_input(ctx, s, ins):
    """axis=None reduces over the FLATTENED array — reshape first so the
    exported graph matches registry semantics."""
    shp = ctx.const("flat", np.asarray([-1], np.int64))
    r = ctx.fresh("flatten1d")
    ctx.emit("Reshape", [ins[0], shp], [r])
    return r


def _reg_arg_conv(op, onnx_op):
    @register_converter(op)
    def conv(ctx, s, ins, out, _onnx=onnx_op):
        a = s._attrs
        axis = a.get("axis")
        keepdims = int(bool(a.get("keepdims", False)))
        if axis is None:
            src = _flat_input(ctx, s, ins)
            ctx.emit(_onnx, [src], [out], attrs={"axis": 0, "keepdims": 0})
        else:
            ctx.emit(_onnx, ins, [out],
                     attrs={"axis": int(axis), "keepdims": keepdims})


_reg_arg_conv("argmax", "ArgMax")
_reg_arg_conv("argmin", "ArgMin")


@register_converter("topk")
def _topk_conv(ctx, s, ins, out):
    a = s._attrs
    if a.get("ret_typ", "indices") not in ("both", "value", "indices"):
        raise ValueError("topk export: ret_typ %r unsupported" % a["ret_typ"])
    k = ctx.const("k", np.asarray([int(a.get("k", 1))], np.int64))
    vals = ctx.fresh("topk_val")
    idx = ctx.fresh("topk_idx")
    ctx.emit("TopK", [ins[0], k], [vals, idx],
             attrs={"axis": int(a.get("axis", -1)),
                    "largest": 0 if a.get("is_ascend", False) else 1})
    ctx.multi[id(s)] = [vals, idx]
    # single-output forms project the right tensor
    primary = vals if a.get("ret_typ", "indices") != "indices" else idx
    ctx.emit("Identity", [primary], [out])


@register_converter("one_hot")
def _one_hot_conv(ctx, s, ins, out):
    a = s._attrs
    depth = ctx.const("depth", np.asarray(int(a["depth"]), np.int64))
    vals = ctx.const("values", np.asarray(
        [float(a.get("off_value", 0.0)), float(a.get("on_value", 1.0))],
        np.float32))
    ctx.emit("OneHot", [ins[0], depth, vals], [out], attrs={"axis": -1})


@register_converter("cumsum")
def _cumsum_conv(ctx, s, ins, out):
    axis = s._attrs.get("axis")
    if axis is None:
        # registry default: cumsum over the FLATTENED array
        src_name = _flat_input(ctx, s, ins)
        axis_c = ctx.const("axis", np.asarray(0, np.int64))
        ctx.emit("CumSum", [src_name, axis_c], [out])
        return
    axis_c = ctx.const("axis", np.asarray(int(axis), np.int64))
    ctx.emit("CumSum", [ins[0], axis_c], [out])


@register_converter("tile")
def _tile_conv(ctx, s, ins, out):
    reps = ctx.const("repeats", np.asarray(s._attrs["reps"], np.int64))
    ctx.emit("Tile", [ins[0], reps], [out])


@register_converter("broadcast_to")
def _broadcast_to_conv(ctx, s, ins, out):
    shape = list(s._attrs["shape"])
    if any(v == 0 for v in shape):
        # MXNet's 0 sentinel (copy this input dim) has no ONNX equivalent —
        # resolve through the input's static shape, or fail loudly
        in_shape = s._inputs[0].shape
        shape = [in_shape[i] if v == 0 else v for i, v in enumerate(shape)]
    shape_c = ctx.const("shape", np.asarray(shape, np.int64))
    ctx.emit("Expand", [ins[0], shape_c], [out])


@register_converter("pad")
def _pad_conv(ctx, s, ins, out):
    a = s._attrs
    mode = a.get("mode", "constant")
    if mode not in ("constant", "edge", "reflect"):
        raise ValueError("pad export: mode %r unsupported" % (mode,))
    pw = a["pad_width"]
    n = len(pw) // 2
    # MXNet interleave (b0, e0, ...) → ONNX [begins..., ends...]
    onnx_pads = [pw[2 * i] for i in range(n)] + \
                [pw[2 * i + 1] for i in range(n)]
    pads = ctx.const("pads", np.asarray(onnx_pads, np.int64))
    cval = ctx.const("cval", np.float32(a.get("constant_value", 0.0)))
    ctx.emit("Pad", [ins[0], pads, cval], [out],
             attrs={"mode": mode})


def _split_conv_impl(ctx, s, ins, out):
    a = s._attrs
    n_out = int(a["num_outputs"])
    if a.get("squeeze_axis"):
        raise ValueError("split export: squeeze_axis unsupported")
    names = [ctx.fresh("split%d" % i) for i in range(n_out)]
    ctx.emit("Split", ins, names, attrs={"axis": int(a.get("axis", 1))})
    ctx.multi[id(s)] = names
    ctx.emit("Identity", [names[0]], [out])


register_converter("split")(_split_conv_impl)
register_converter("SliceChannel")(_split_conv_impl)


# ------------------------------------------------- ONNX-parity op converters
# (ops/extra.py "ONNX-parity ops" section: importer counterparts live in
# import_model.py; these close the round trip)

@register_converter("einsum")
def _einsum_conv(ctx, s, ins, out):
    ctx.emit("Einsum", list(ins), [out],
             attrs={"equation": s._attrs["equation"]})


@register_converter("take_along_axis")
def _take_along_axis_conv(ctx, s, ins, out):
    idx = ctx.fresh("idx64")
    ctx.emit("Cast", [ins[1]], [idx], attrs={"to": 7})  # GatherElements: int64
    ctx.emit("GatherElements", [ins[0], idx], [out],
             attrs={"axis": int(s._attrs.get("axis", 0))})


@register_converter("scatter_elements")
def _scatter_elements_conv(ctx, s, ins, out):
    idx = ctx.fresh("idx64")
    ctx.emit("Cast", [ins[1]], [idx], attrs={"to": 7})
    attrs = {"axis": int(s._attrs.get("axis", 0))}
    red = s._attrs.get("reduction", "none")
    if red != "none":
        if ctx.opset < 16:
            raise ValueError("scatter_elements with reduction=%r needs "
                             "opset>=16; pass opset=16 to export_model"
                             % red)
        attrs["reduction"] = red
    ctx.emit("ScatterElements", [ins[0], idx, ins[2]], [out], attrs=attrs)


@register_converter("trilu")
def _trilu_conv(ctx, s, ins, out):
    if ctx.opset < 14:
        raise ValueError("trilu export needs opset>=14 (Trilu); pass "
                         "opset=14 to export_model")
    k = ctx.const("k", np.asarray(int(s._attrs.get("k", 0)), np.int64))
    ctx.emit("Trilu", [ins[0], k], [out],
             attrs={"upper": int(bool(s._attrs.get("upper", True)))})


@register_converter("celu")
def _celu_conv(ctx, s, ins, out):
    ctx.emit("Celu", ins[:1], [out],
             attrs={"alpha": float(s._attrs.get("alpha", 1.0))})


@register_converter("hardswish")
def _hardswish_conv(ctx, s, ins, out):
    if ctx.opset >= 14:
        ctx.emit("HardSwish", ins[:1], [out])
        return
    # opset 13 decomposition: x * HardSigmoid(x, alpha=1/6, beta=0.5)
    hs = ctx.fresh("hsig")
    ctx.emit("HardSigmoid", ins[:1], [hs],
             attrs={"alpha": 1.0 / 6.0, "beta": 0.5})
    ctx.emit("Mul", [ins[0], hs], [out])


@register_converter("thresholded_relu")
def _thresholded_relu_conv(ctx, s, ins, out):
    ctx.emit("ThresholdedRelu", ins[:1], [out],
             attrs={"alpha": float(s._attrs.get("alpha", 1.0))})


@register_converter("logsumexp")
def _logsumexp_conv(ctx, s, ins, out):
    a = s._attrs
    attrs = {"keepdims": int(bool(a.get("keepdims", False)))}
    ax = a.get("axis")
    if ax is not None:
        attrs["axes"] = [ax] if isinstance(ax, int) else list(ax)
    ctx.emit("ReduceLogSumExp", ins[:1], [out], attrs=attrs)


@register_converter("size_array")
def _size_array_conv(ctx, s, ins, out):
    ctx.emit("Size", ins[:1], [out])


@register_converter("scaled_dot_attention")
def _sdpa_conv(ctx, s, ins, out):
    """Decompose the attention seam into MatMul/Softmax — the lowering
    upstream mx2onnx applies to gluonnlp's BERT interleaved-matmul ops
    (python/mxnet/onnx/mx2onnx/_op_translations). q,k,v (B, H, T, D);
    optional mask input (1=keep) becomes an additive -1e9; causal=True
    bakes a (1, 1, Tq, Tk) triangular additive constant (shapes are static
    at export like every symbol_to_onnx graph)."""
    a = s._attrs
    q_shape = s._inputs[0].shape
    k_shape = s._inputs[1].shape
    D = q_shape[-1]
    scale = a.get("scale") or (1.0 / np.sqrt(D))

    kt = ctx.fresh("kT")
    ctx.emit("Transpose", [ins[1]], [kt], attrs={"perm": [0, 1, 3, 2]})
    raw = ctx.fresh("scores")
    ctx.emit("MatMul", [ins[0], kt], [raw])
    sc = ctx.const("sdpa_scale", np.float32(scale))
    scores = ctx.fresh("scaled")
    ctx.emit("Mul", [raw, sc], [scores])
    if a.get("causal"):
        tq, tk = q_shape[-2], k_shape[-2]
        tri = np.where(np.arange(tk)[None, :] <= np.arange(tq)[:, None],
                       0.0, -1e9).astype(np.float32)[None, None]
        add = ctx.const("causal_bias", tri)
        nxt = ctx.fresh("causal_scores")
        ctx.emit("Add", [scores, add], [nxt])
        scores = nxt
    if len(ins) > 3:  # boolean keep-mask input
        mb = ctx.fresh("mask_bool")
        ctx.emit("Cast", [ins[3]], [mb], attrs={"to": 9})
        neg = ctx.const("sdpa_neg", np.float32(-1e9))
        masked = ctx.fresh("masked_scores")
        ctx.emit("Where", [mb, scores, neg], [masked])
        scores = masked
    probs = ctx.fresh("attn_probs")
    ctx.emit("Softmax", [scores], [probs], attrs={"axis": -1})
    ctx.emit("MatMul", [probs, ins[2]], [out])


@register_converter("_arange")
def _arange_conv(ctx, s, ins, out):
    a = s._attrs
    arr = np.arange(a["start"], a["stop"], a.get("step", 1.0),
                    dtype=_np_dtype(a.get("dtype") or "float32"))
    rep = int(a.get("repeat", 1))
    ctx.initializers[out] = np.repeat(arr, rep) if rep != 1 else arr
