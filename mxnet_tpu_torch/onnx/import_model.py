"""ONNX ModelProto → Symbol graph + params (counterpart of
``mxnet_tpu/onnx/import_model.py``; ref:
python/mxnet/onnx/onnx2mx/import_model.py and _op_translations — the
reference builds an nnvm symbol per ONNX node; this builds the port's
Symbols over its op registry, so ``LayerNormalization`` becomes the port's
``LayerNorm`` op and a CUDA tensor takes the LayerNorm kernel).

Coverage mirrors what export.py emits (the model-zoo op set); unknown ops
raise with the op name so gaps are explicit.
"""
from __future__ import annotations

import numpy as np

from . import proto as P
from ..symbol import Symbol, _make, var

_IMPORTERS = {}


def register_importer(onnx_op):
    def deco(fn):
        _IMPORTERS[onnx_op] = fn
        return fn
    return deco


class _Graph:
    def __init__(self, parsed, opset=13):
        self.initializers = parsed["initializers"]  # name -> np array
        self.syms = {}                              # value name -> Symbol
        self.used_params = set()
        self.opset = opset

    def inp(self, name):
        """Symbol for a node input; initializer-backed names become vars."""
        if name in self.syms:
            return self.syms[name]
        if name in self.initializers:
            self.used_params.add(name)
            s = var(name)
            self.syms[name] = s
            return s
        raise KeyError("undefined ONNX value %r" % name)

    def const_value(self, name):
        """Static value of an initializer-fed input (Reshape shape etc.)."""
        if name not in self.initializers:
            raise ValueError("input %r must be a constant initializer" % name)
        return self.initializers[name]


def _sym_pair(v):
    return tuple(v)


# ----------------------------------------------------------------- importers

@register_importer("Conv")
def _conv(g, node):
    a = node["attrs"]
    pads = a.get("pads")
    nd = len(a["kernel_shape"])
    if pads:
        begin, end = pads[:nd], pads[nd:]
        if begin != end:
            raise ValueError("asymmetric Conv pads unsupported: %s" % pads)
        pad = tuple(begin)
    else:
        pad = (0,) * nd
    ins = [g.inp(n) for n in node["inputs"]]
    return _make("Convolution", *ins, kernel=tuple(a["kernel_shape"]),
                 stride=tuple(a.get("strides", (1,) * nd)), pad=pad,
                 dilate=tuple(a.get("dilations", (1,) * nd)),
                 num_group=int(a.get("group", 1)),
                 no_bias=len(ins) < 3)


@register_importer("ConvTranspose")
def _deconv(g, node):
    a = node["attrs"]
    nd = len(a["kernel_shape"])
    pads = a.get("pads")
    pad = tuple(pads[:nd]) if pads else (0,) * nd
    ins = [g.inp(n) for n in node["inputs"]]
    kw = dict(kernel=tuple(a["kernel_shape"]),
              stride=tuple(a.get("strides", (1,) * nd)), pad=pad,
              dilate=tuple(a.get("dilations", (1,) * nd)),
              num_group=int(a.get("group", 1)), no_bias=len(ins) < 3)
    if a.get("output_padding"):
        kw["adj"] = tuple(a["output_padding"])
    return _make("Deconvolution", *ins, **kw)


@register_importer("Gemm")
def _gemm(g, node):
    a = node["attrs"]
    if a.get("transA") or not a.get("transB", 0):
        raise ValueError("only Gemm(transA=0, transB=1) supported")
    alpha, beta = float(a.get("alpha", 1.0)), float(a.get("beta", 1.0))
    for name, scale in [(node["inputs"][1], alpha)] + (
            [(node["inputs"][2], beta)] if len(node["inputs"]) > 2 else []):
        if scale != 1.0:
            init = g.initializers.get(name)
            if init is None:
                raise ValueError("Gemm alpha/beta != 1 on non-initializer input")
            g.initializers[name] = np.asarray(init) * scale
    ins = [g.inp(n) for n in node["inputs"]]
    w = g.initializers.get(node["inputs"][1])
    num_hidden = int(w.shape[0]) if w is not None else 0
    return _make("FullyConnected", *ins, num_hidden=num_hidden,
                 no_bias=len(ins) < 3, flatten=True)


@register_importer("MatMul")
def _matmul(g, node):
    return _make("matmul", g.inp(node["inputs"][0]), g.inp(node["inputs"][1]))


@register_importer("BatchNormalization")
def _bn(g, node):
    a = node["attrs"]
    ins = [g.inp(n) for n in node["inputs"]]
    out = _make("BatchNorm", *ins, eps=float(a.get("epsilon", 1e-5)),
                momentum=float(a.get("momentum", 0.9)),
                use_global_stats=True)
    return out[0]


@register_importer("LayerNormalization")
def _ln(g, node):
    a = node["attrs"]
    ins = [g.inp(n) for n in node["inputs"]]
    return _make("LayerNorm", *ins, axis=int(a.get("axis", -1)),
                 eps=float(a.get("epsilon", 1e-5)))


for _onnx, _act in [("Relu", "relu"), ("Sigmoid", "sigmoid"), ("Tanh", "tanh"),
                    ("Softplus", "softrelu"), ("Softsign", "softsign")]:
    def _mk_act(act):
        def imp(g, node):
            return _make("Activation", g.inp(node["inputs"][0]), act_type=act)
        return imp
    register_importer(_onnx)(_mk_act(_act))


@register_importer("LeakyRelu")
def _leaky(g, node):
    return _make("LeakyReLU", g.inp(node["inputs"][0]), act_type="leaky",
                 slope=float(node["attrs"].get("alpha", 0.01)))


@register_importer("Elu")
def _elu(g, node):
    return _make("LeakyReLU", g.inp(node["inputs"][0]), act_type="elu",
                 slope=float(node["attrs"].get("alpha", 1.0)))


@register_importer("PRelu")
def _prelu(g, node):
    return _make("LeakyReLU", g.inp(node["inputs"][0]),
                 g.inp(node["inputs"][1]), act_type="prelu")


@register_importer("Selu")
def _selu(g, node):
    return _make("LeakyReLU", g.inp(node["inputs"][0]), act_type="selu")


@register_importer("Gelu")
def _gelu(g, node):
    return _make("LeakyReLU", g.inp(node["inputs"][0]), act_type="gelu")


def _pool(ptype):
    def imp(g, node):
        a = node["attrs"]
        nd = len(a["kernel_shape"])
        pads = a.get("pads")
        pad = tuple(pads[:nd]) if pads else (0,) * nd
        kw = dict(kernel=tuple(a["kernel_shape"]),
                  stride=tuple(a.get("strides", (1,) * nd)),
                  pad=pad, pool_type=ptype)
        if ptype == "avg":
            kw["count_include_pad"] = bool(a.get("count_include_pad", 0))
        if ptype == "lp":
            kw["p_value"] = int(a.get("p", 2))
        return _make("Pooling", g.inp(node["inputs"][0]), **kw)
    return imp


register_importer("MaxPool")(_pool("max"))
register_importer("AveragePool")(_pool("avg"))
register_importer("LpPool")(_pool("lp"))


@register_importer("GlobalAveragePool")
def _gap(g, node):
    return _make("Pooling", g.inp(node["inputs"][0]), kernel=(1, 1),
                 pool_type="avg", global_pool=True)


@register_importer("GlobalMaxPool")
def _gmp(g, node):
    return _make("Pooling", g.inp(node["inputs"][0]), kernel=(1, 1),
                 pool_type="max", global_pool=True)


@register_importer("Dropout")
def _dropout(g, node):
    return g.inp(node["inputs"][0])  # inference: identity


@register_importer("Identity")
def _identity(g, node):
    return g.inp(node["inputs"][0])


@register_importer("Gather")
def _gather(g, node):
    axis = int(node["attrs"].get("axis", 0))
    return _make("take", g.inp(node["inputs"][0]), g.inp(node["inputs"][1]),
                 axis=axis, mode="clip")


@register_importer("Flatten")
def _flatten(g, node):
    if int(node["attrs"].get("axis", 1)) != 1:
        raise ValueError("Flatten axis != 1 unsupported")
    return _make("flatten", g.inp(node["inputs"][0]))


@register_importer("Softmax")
def _softmax(g, node):
    return _make("softmax", g.inp(node["inputs"][0]),
                 axis=int(node["attrs"].get("axis", -1)))


@register_importer("LogSoftmax")
def _log_softmax(g, node):
    return _make("log_softmax", g.inp(node["inputs"][0]),
                 axis=int(node["attrs"].get("axis", -1)))


@register_importer("Concat")
def _concat(g, node):
    ins = [g.inp(n) for n in node["inputs"]]
    return _make("concat", *ins, dim=int(node["attrs"].get("axis", 1)))


@register_importer("Reshape")
def _reshape(g, node):
    shape = tuple(int(v) for v in g.const_value(node["inputs"][1]))
    return _make("reshape", g.inp(node["inputs"][0]), shape=shape)


@register_importer("Transpose")
def _transpose(g, node):
    perm = node["attrs"].get("perm")
    return _make("transpose", g.inp(node["inputs"][0]),
                 axes=tuple(perm) if perm else None)


@register_importer("Unsqueeze")
def _unsqueeze(g, node):
    if len(node["inputs"]) > 1:
        axes = [int(v) for v in g.const_value(node["inputs"][1])]
    else:
        axes = node["attrs"]["axes"]
    out = g.inp(node["inputs"][0])
    for ax in axes:
        out = _make("expand_dims", out, axis=int(ax))
    return out


@register_importer("Squeeze")
def _squeeze(g, node):
    if len(node["inputs"]) > 1:
        axes = tuple(int(v) for v in g.const_value(node["inputs"][1]))
    elif "axes" in node["attrs"]:
        axes = tuple(node["attrs"]["axes"])
    else:
        axes = None
    return _make("squeeze", g.inp(node["inputs"][0]), axis=axes)


@register_importer("Clip")
def _clip(g, node):
    lo = float(g.const_value(node["inputs"][1])) if len(node["inputs"]) > 1 else -np.inf
    hi = float(g.const_value(node["inputs"][2])) if len(node["inputs"]) > 2 else np.inf
    return _make("clip", g.inp(node["inputs"][0]), a_min=lo, a_max=hi)


@register_importer("Slice")
def _slice(g, node):
    starts = [int(v) for v in g.const_value(node["inputs"][1])]
    ends = [int(v) for v in g.const_value(node["inputs"][2])]
    axes = ([int(v) for v in g.const_value(node["inputs"][3])]
            if len(node["inputs"]) > 3 and node["inputs"][3]
            else list(range(len(starts))))
    steps = ([int(v) for v in g.const_value(node["inputs"][4])]
             if len(node["inputs"]) > 4 and node["inputs"][4]
             else [1] * len(starts))
    out = g.inp(node["inputs"][0])
    imax = np.iinfo(np.int64).max
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        if sp == 1:
            out = _make("slice_axis", out, axis=ax, begin=st,
                        end=None if en >= imax else en)
        elif sp == -1 and st == -1 and en <= -imax + 1:
            # full reversal along ax (the SequenceReverse lowering)
            out = _make("reverse", out, axis=ax)
        else:
            raise ValueError(
                "Slice import: step %d (start %d, end %d) unsupported — "
                "only unit steps and full reversals map to registry ops"
                % (sp, st, en))
    return out


def _reduce(mx_op):
    def imp(g, node):
        a = node["attrs"]
        axes = a.get("axes")
        if axes is None and len(node["inputs"]) > 1:
            # opset>=13 ReduceSum: axes is a second (initializer) input
            ax_init = g.initializers.get(node["inputs"][1])
            if ax_init is None:
                raise ValueError("%s: dynamic axes input unsupported"
                                 % node["op"])
            axes = [int(x) for x in np.asarray(ax_init).reshape(-1)]
        if _reduce_is_noop(node, axes):
            return _make("identity", g.inp(node["inputs"][0]))
        kw = {"keepdims": bool(a.get("keepdims", 1))}
        if axes:
            kw["axis"] = tuple(axes) if len(axes) > 1 else int(axes[0])
        return _make(mx_op, g.inp(node["inputs"][0]), **kw)
    return imp


for _onnx, _mx in [("ReduceMean", "mean"), ("ReduceSum", "sum"),
                   ("ReduceMax", "max"), ("ReduceMin", "min"),
                   ("ReduceProd", "prod")]:
    register_importer(_onnx)(_reduce(_mx))


def _binop(mx_op):
    def imp(g, node):
        return _make(mx_op, g.inp(node["inputs"][0]), g.inp(node["inputs"][1]))
    return imp


for _onnx, _mx in [("Add", "add"), ("Sub", "subtract"), ("Mul", "multiply"),
                   ("Div", "divide"), ("Pow", "power")]:
    register_importer(_onnx)(_binop(_mx))


def _minmax(mx_op):
    def imp(g, node):
        out = g.inp(node["inputs"][0])
        for n in node["inputs"][1:]:
            out = _make(mx_op, out, g.inp(n))
        return out
    return imp


register_importer("Max")(_minmax("maximum"))
register_importer("Min")(_minmax("minimum"))


def _unop(mx_op):
    def imp(g, node):
        return _make(mx_op, g.inp(node["inputs"][0]))
    return imp


for _onnx, _mx in [("Exp", "exp"), ("Log", "log"), ("Sqrt", "sqrt"),
                   ("Neg", "negative"), ("Abs", "abs"), ("Floor", "floor"),
                   ("Ceil", "ceil"), ("Round", "round"), ("Erf", "erf"),
                   ("Sin", "sin"), ("Cos", "cos"), ("Tan", "tan"),
                   ("Reciprocal", "reciprocal"), ("Sign", "sign"),
                   ("Asin", "arcsin"), ("Acos", "arccos"),
                   ("Atan", "arctan"), ("Sinh", "sinh"), ("Cosh", "cosh"),
                   ("Asinh", "arcsinh"), ("Acosh", "arccosh"),
                   ("Atanh", "arctanh"), ("IsNaN", "isnan")]:
    register_importer(_onnx)(_unop(_mx))


@register_importer("IsInf")
def _isinf_imp(g, node):
    a = node["attrs"]
    if not int(a.get("detect_negative", 1)) or \
            not int(a.get("detect_positive", 1)):
        raise ValueError("IsInf import: one-sided detect_negative/"
                         "detect_positive not supported")
    return _make("isinf", g.inp(node["inputs"][0]))


@register_importer("Shape")
def _shape(g, node):
    return _make("_onnx_shape", g.inp(node["inputs"][0]))


@register_importer("ConstantOfShape")
def _constant_of_shape(g, node):
    val = node["attrs"].get("value")
    v = float(np.asarray(val).reshape(-1)[0]) if val is not None else 0.0
    ins = node["inputs"]
    if ins[0] in g.initializers:
        shape = tuple(int(x) for x in np.asarray(g.const_value(ins[0])))
        return _make("_filled", shape=shape, value=v)
    src = g.inp(ins[0])
    if src._op == "_onnx_shape":
        # ConstantOfShape(Shape(x)) — the zeros_like/full_like lowering
        base = _make("zeros_like", src._inputs[0])
        return base if v == 0.0 else _make("add", base, v)
    raise ValueError("ConstantOfShape: shape input must be a constant or a "
                     "Shape node")


@register_importer("Cast")
def _cast(g, node):
    to = int(node["attrs"]["to"])
    dtype = np.dtype(P.onnx_to_np_dtype(to)).name
    return _make("cast", g.inp(node["inputs"][0]), dtype=dtype)


def _import_subgraph(g, graphd, tag, bound_inputs=()):
    """Run a subgraph's nodes through the importers in a scoped symbol table
    (ONNX scoping: inner names may shadow outer; restored afterwards).
    ``bound_inputs``: {formal input name: Symbol} for loop vars. Returns the
    list of subgraph output Symbols. Shared by If/Scan (and future Loop)."""
    saved_syms = dict(g.syms)
    for k, v in graphd.get("initializers", {}).items():
        if k in g.initializers and not np.array_equal(g.initializers[k], v):
            raise ValueError(
                "%s import: subgraph initializer %r shadows an outer "
                "initializer with different data" % (tag, k))
        g.initializers[k] = v
    try:
        for nm, sy in dict(bound_inputs).items():
            g.syms[nm] = sy
        for sub in graphd["nodes"]:
            imp = _IMPORTERS.get(sub["op"])
            if imp is None:
                raise ValueError("no importer for ONNX op %r (%s subgraph)"
                                 % (sub["op"], tag))
            out = imp(g, sub)
            outs = out if isinstance(out, (list, tuple)) else [out]
            for nm, sy in zip(sub["outputs"], outs):
                g.syms[nm] = sy
        return [g.syms[vi["name"]] for vi in graphd["outputs"]]
    finally:
        g.syms = saved_syms


@register_importer("If")
def _if(g, node):
    """ONNX If → symbol.cond. Subgraph nodes may reference
    outer-scope values by name (ONNX scoping) — they resolve through the
    shared _Graph symbol table."""
    a = node["attrs"]
    then_s = _import_subgraph(g, a["then_branch"], "If")[0]
    else_s = _import_subgraph(g, a["else_branch"], "If")[0]
    from ..symbol import cond
    return cond(g.inp(node["inputs"][0]), then_s, else_s)


@register_importer("Scan")
def _scan_imp(g, node):
    """ONNX Scan → symbol foreach node. Body formal inputs are
    [states..., scan slice]; outer-scope references resolve through the
    shared symbol table like If branches."""
    from ..symbol import Symbol

    a = node["attrs"]
    body = a["body"]
    num_scan = int(a.get("num_scan_inputs", 1))
    if num_scan != 1:
        raise ValueError("Scan import: only one scan input supported")
    n_states = len(node["inputs"]) - num_scan
    binput_names = [vi["name"] for vi in body["inputs"]]
    state_names, slice_name = binput_names[:n_states], binput_names[-1]

    body_outs = _import_subgraph(
        g, body, "Scan",
        bound_inputs={nm: Symbol(None, name=nm) for nm in binput_names})
    state_syms, out_sym = body_outs[:n_states], body_outs[-1]

    data = g.inp(node["inputs"][-1])
    inits = [g.inp(n) for n in node["inputs"][:n_states]]
    fnode = _foreach_node(data, inits, out_sym, state_syms, slice_name,
                          state_names)
    # ONNX output order: final_states..., stacked scan output; ours is
    # [stacked, states...]
    return [fnode[i + 1] for i in range(n_states)] + [fnode[0]]


@register_importer("Loop")
def _loop_imp(g, node):
    """ONNX Loop → symbol while_loop (a masked scan of a static length).

    Body formals are [iteration_num, cond_in, carried...]; body outputs are
    [cond_out, carried..., scan_outputs...]. The trip count M must be a
    constant (XLA needs a static bound to stack per-step outputs). Static-
    shape deviation from the spec: scan outputs always have M rows — rows
    after the condition turns false are zero (the while_loop masking),
    where ONNX would return only the executed prefix.
    """
    from ..symbol import Symbol, while_loop

    a = node["attrs"]
    body = a["body"]
    ins = node["inputs"]
    m_name, cond_name = ins[0], ins[1]
    carried_names = list(ins[2:])
    n_carried = len(carried_names)
    if not m_name:
        raise ValueError(
            "Loop import: trip count M is required and must be constant "
            "(a static bound is what lets XLA compile the loop)")
    M = int(np.asarray(g.const_value(m_name)).reshape(()))

    binputs = [vi["name"] for vi in body["inputs"]]
    if len(binputs) != 2 + n_carried:
        raise ValueError("Loop body has %d inputs, expected %d"
                         % (len(binputs), 2 + n_carried))
    iter_name, cond_in_name = binputs[0], binputs[1]
    bstate_names = binputs[2:]
    n_scan = len(body["outputs"]) - 1 - n_carried
    if n_scan < 0:
        raise ValueError("Loop body must output [cond, carried..., scans...]")
    if n_scan > 1:
        raise ValueError("Loop import: at most one scan output supported "
                         "(while_loop stacks a single per-step Symbol)")

    def _bool_const(v):
        f = _make("_filled", shape=(), value=1.0 if v else 0.0)
        return _make("cast", f, dtype="bool")

    iter0 = _make("cast", _make("_filled", shape=(), value=0.0),
                  dtype="int64")
    init_cond = g.inp(cond_name) if cond_name else _bool_const(True)
    init_states = [g.inp(n) for n in carried_names]

    def cond_fn(vs):
        return vs[1]

    def func(vs):
        i, c = vs[0], vs[1]
        bound = {iter_name: i, cond_in_name: c}
        bound.update(dict(zip(bstate_names, vs[2:])))
        outs = _import_subgraph(g, body, "Loop", bound_inputs=bound)
        cond_out = outs[0]
        states_out = list(outs[1:1 + n_carried])
        scan_outs = list(outs[1 + n_carried:])
        out_sym = scan_outs[0] if scan_outs else cond_out  # dummy when K=0
        i_next = _make("cast", _make("add", _make("cast", i,
                                                  dtype="float32"), 1.0),
                       dtype="int64")
        return out_sym, [i_next, cond_out] + states_out

    outputs, final_vars = while_loop(cond_fn, func,
                                     [iter0, init_cond] + init_states,
                                     max_iterations=M)
    result = list(final_vars[2:])
    if n_scan:
        result.append(outputs)
    return result


@register_importer("NonMaxSuppression")
def _nms(g, node):
    ins = node["inputs"]
    kw = {"center_point_box": int(node["attrs"].get("center_point_box", 0))}
    if len(ins) > 2 and ins[2]:
        kw["max_output_boxes_per_class"] = int(
            np.asarray(g.const_value(ins[2])).reshape(()))
    if len(ins) > 3 and ins[3]:
        kw["iou_threshold"] = float(np.asarray(g.const_value(ins[3])).reshape(()))
    if len(ins) > 4 and ins[4]:
        kw["score_threshold"] = float(np.asarray(g.const_value(ins[4])).reshape(()))
    return _make("_onnx_nms", g.inp(ins[0]), g.inp(ins[1]), **kw)


@register_importer("GatherND")
def _gather_nd(g, node):
    if node["attrs"].get("batch_dims"):
        raise ValueError("GatherND import: batch_dims unsupported")
    return _make("_onnx_gather_nd", g.inp(node["inputs"][0]),
                 g.inp(node["inputs"][1]))


@register_importer("ScatterND")
def _scatter_nd(g, node):
    return _make("_onnx_scatter_nd", g.inp(node["inputs"][0]),
                 g.inp(node["inputs"][1]), g.inp(node["inputs"][2]))


def _import_resize(g, node, scales, sizes):
    a = node["attrs"]
    mode = a.get("mode", "nearest")
    x = g.inp(node["inputs"][0])
    if mode == "nearest":
        if scales is None:
            raise ValueError("nearest Resize import needs scales")
        s = [float(v) for v in scales]
        if s[0] != 1 or s[1] != 1 or s[2] != s[3] or s[2] != int(s[2]):
            raise ValueError("nearest Resize: only uniform integer spatial "
                             "scales supported, got %r" % (s,))
        return _make("UpSampling", x, scale=int(s[2]), sample_type="nearest")
    if mode != "linear":
        raise ValueError("Resize mode %r unsupported" % mode)
    ctm = a.get("coordinate_transformation_mode", "half_pixel")
    ops = {"align_corners": "BilinearResize2D",
           "asymmetric": "_resize_linear_asymmetric",
           "half_pixel": "_resize_linear_half_pixel",
           "pytorch_half_pixel": "_resize_linear_half_pixel"}
    if ctm not in ops:
        raise ValueError("linear Resize import: coordinate_transformation_"
                         "mode %r unsupported" % ctm)
    kw = ({"pytorch_mode": ctm == "pytorch_half_pixel"}
          if ops[ctm] == "_resize_linear_half_pixel" else {})
    if sizes is not None:
        return _make(ops[ctm], x, height=int(sizes[2]), width=int(sizes[3]),
                     **kw)
    return _make(ops[ctm], x, scale_height=float(scales[2]),
                 scale_width=float(scales[3]), **kw)


@register_importer("Resize")
def _resize(g, node):
    ins = node["inputs"]
    scales = sizes = None
    if len(ins) > 2 and ins[2]:
        v = np.asarray(g.const_value(ins[2]))
        scales = v if v.size else None
    if len(ins) > 3 and ins[3]:
        sizes = np.asarray(g.const_value(ins[3]))
    return _import_resize(g, node, scales, sizes)


@register_importer("Upsample")
def _upsample(g, node):
    # opset-9 deprecated form: scales as input 1 (or attr pre-9)
    scales = node["attrs"].get("scales")
    if scales is None:
        scales = np.asarray(g.const_value(node["inputs"][1]))
    return _import_resize(g, node, np.asarray(scales, np.float64), None)


# ------------------------------------------------------------ recurrent ops

_uid = [0]


def _fresh(hint):
    _uid[0] += 1
    return "%s_%d" % (hint, _uid[0])


def _rnn_import(mode):
    """ONNX LSTM/GRU/RNN (single layer, 1-2 directions) → fused mx RNN op.
    Gate blocks are re-ordered from ONNX to MXNet order (see export.py)."""
    from .export import _GRU_FROM_ONNX, _LSTM_FROM_ONNX, _gate_perm

    def imp(g, node):
        a = node["attrs"]
        ins = node["inputs"]
        W = np.asarray(g.const_value(ins[1]), np.float32)  # (D, G*H, C)
        R = np.asarray(g.const_value(ins[2]), np.float32)  # (D, G*H, H)
        D, GH, _ = W.shape
        H = int(a.get("hidden_size", R.shape[2]))
        direction = a.get("direction", "forward")
        if direction == "reverse":
            raise ValueError("RNN import: direction=reverse unsupported")
        bi = direction == "bidirectional"
        mx_mode = mode
        if mode == "rnn":
            acts = [s.lower() for s in a.get("activations", ["Tanh"] * D)]
            if acts[0] not in ("tanh", "relu"):
                raise ValueError("RNN import: activation %r" % acts[0])
            mx_mode = "rnn_" + acts[0]
        if mode == "gru" and not a.get("linear_before_reset", 0):
            raise ValueError(
                "GRU import: linear_before_reset=0 (reset before the "
                "recurrent matmul) has no fused-op equivalent here")
        inv = {"lstm": _LSTM_FROM_ONNX, "gru": _GRU_FROM_ONNX}.get(mode, [0])
        if len(ins) > 3 and ins[3]:
            B = np.asarray(g.const_value(ins[3]), np.float32)
        else:
            B = np.zeros((D, 2 * GH), np.float32)

        wsyms = []
        for d in range(D):
            for hint, arr in [("i2h_weight", _gate_perm(W[d], inv, H)),
                              ("h2h_weight", _gate_perm(R[d], inv, H)),
                              ("i2h_bias", _gate_perm(B[d][:GH], inv, H)),
                              ("h2h_bias", _gate_perm(B[d][GH:], inv, H))]:
                name = _fresh("%s_%s" % (node.get("name") or "rnn", hint))
                g.initializers[name] = arr
                wsyms.append(g.inp(name))

        x = g.inp(ins[0])
        if len(ins) > 5 and ins[5]:
            h0 = g.inp(ins[5])
        else:
            h0 = _make("_rnn_init", x, num=D, hidden=H)
        if mode == "lstm" and len(ins) > 6 and ins[6]:
            c0 = g.inp(ins[6])
        else:
            c0 = _make("_rnn_init", x, num=D, hidden=H)
        rnn = _make("RNN", x, h0, c0, *wsyms, mode=mx_mode, num_layers=1,
                    bidirectional=bi)
        # mx out (T, N, D*H) → ONNX Y (T, D, N, H)
        y = _make("transpose",
                  _make("reshape", rnn[0], shape=(0, 0, D, H)),
                  axes=(0, 2, 1, 3))
        outs = [y, rnn[1]]
        if mode == "lstm":
            outs.append(rnn[2])
        return outs[:len(node["outputs"])]
    return imp


register_importer("LSTM")(_rnn_import("lstm"))
register_importer("GRU")(_rnn_import("gru"))
register_importer("RNN")(_rnn_import("rnn"))


@register_importer("Constant")
def _constant(g, node):
    val = node["attrs"].get("value")
    s = var(node["outputs"][0])
    g.initializers[node["outputs"][0]] = np.asarray(val)
    g.used_params.add(node["outputs"][0])
    return s


# ----------------------------------------------------------------- front end

def import_model(model_file):
    """ONNX file/bytes → (sym, arg_params, aux_params)
    (ref: python/mxnet/onnx/onnx2mx/import_model.py:import_model).

    aux_params holds BatchNorm running stats (inputs 3/4 of
    BatchNormalization), matching MXNet's arg/aux split.
    """
    if isinstance(model_file, (bytes, bytearray)):
        buf = bytes(model_file)
    else:
        with open(model_file, "rb") as f:
            buf = f.read()
    parsed = P.parse_model(buf)
    graph = parsed["graph"]
    g = _Graph(graph, opset=parsed.get("opset", 13))

    for vi in graph["inputs"]:
        if vi["name"] not in g.initializers:
            g.syms[vi["name"]] = var(vi["name"])

    aux_names = set()
    for node in graph["nodes"]:
        if node["op"] == "BatchNormalization":
            aux_names.update(node["inputs"][3:5])

    for node in graph["nodes"]:
        imp = _IMPORTERS.get(node["op"])
        if imp is None:
            raise ValueError("no importer for ONNX op %r" % node["op"])
        out = imp(g, node)
        outs = out if isinstance(out, (list, tuple)) else [out]
        for name, s in zip(node["outputs"], outs):
            s.name = s.name if s.is_var() else name
            g.syms[name] = s

    out_syms = [g.syms[o["name"]] for o in graph["outputs"]]
    if len(out_syms) == 1:
        sym_out = out_syms[0]
    else:
        from ..symbol import Group

        sym_out = Group(out_syms)

    arg_params, aux_params = {}, {}
    for name in g.used_params:
        arr = g.initializers[name]
        (aux_params if name in aux_names else arg_params)[name] = arr
    return sym_out, arg_params, aux_params


def import_to_gluon(model_file, ctx=None):
    """ONNX file → executable SymbolBlock
    (ref: python/mxnet/onnx/onnx2mx/import_to_gluon.py), its parameters on
    ``ctx`` (a Context or device; default the innermost ``with ctx:``, else
    the current CUDA device, ``DeviceError`` without one), each in the
    file's dtype. The block is hybridized, as ``SymbolBlock.imports``'s is."""
    from ..base import resolve_device
    from ..gluon.block import SymbolBlock
    from ..gluon.parameter import Parameter
    from ..util import to_tensor

    device = resolve_device(ctx)

    sym_out, arg_params, aux_params = import_model(model_file)
    param_names = set(arg_params) | set(aux_params)
    # list_arguments() is deterministic depth-first order — input binding in
    # SymbolBlock.forward is positional, so order must be stable
    input_names = [n for n in sym_out.list_arguments() if n not in param_names]
    inputs = [var(n) for n in input_names]
    blk = SymbolBlock(sym_out, inputs)
    for name, arr in {**arg_params, **aux_params}.items():
        t = to_tensor(np.asarray(arr))
        p = Parameter(name, shape=tuple(arr.shape), dtype=t.dtype)
        p.set_data(t.to(device))
        blk._params._params[name] = p
    blk.hybridize()
    return blk


def _foreach_node(data, states, out_sym, state_syms, slice_name, state_names,
                  name=None):
    """The ``_foreach`` Symbol over already-built body subgraphs (the JAX
    package's ``symbol._foreach_node``, which the port's ``foreach`` builds
    inline)."""
    from ..symbol import _free_args

    loop_names = {slice_name} | set(state_names)
    free = _free_args([out_sym] + list(state_syms), loop_names)
    return Symbol("_foreach", [data] + list(states) + free,
                  {"out_sym": out_sym, "state_syms": list(state_syms),
                   "slice_name": slice_name,
                   "state_names": list(state_names),
                   "free_names": [a.name for a in free],
                   "n_states": len(states)},
                  name=name)


def _scalar(v):
    """Python scalar from a 0-d or 1-element initializer (NumPy >=1.25
    errors on int(array) with ndim > 0)."""
    return np.asarray(v).reshape(-1)[0]


# --------------------------- breadth batch: official-producer common ops

def _reg_elemwise_imp(onnx_name, op):
    @register_importer(onnx_name)
    def f(g, node, _op=op):
        ins = [g.inp(n) for n in node["inputs"]]
        return _make(_op, *ins)


# NOTE: Max/Min already have variadic importers above (pairwise fold) —
# do not re-register them with binary ops
_reg_elemwise_imp("Where", "where")
_reg_elemwise_imp("Equal", "broadcast_equal")
_reg_elemwise_imp("Greater", "broadcast_greater")
_reg_elemwise_imp("Less", "broadcast_lesser")
_reg_elemwise_imp("Not", "logical_not")
_reg_elemwise_imp("And", "broadcast_logical_and")
_reg_elemwise_imp("Or", "broadcast_logical_or")
_reg_elemwise_imp("Xor", "broadcast_logical_xor")
_reg_elemwise_imp("GreaterOrEqual", "broadcast_greater_equal")
_reg_elemwise_imp("LessOrEqual", "broadcast_lesser_equal")
_reg_elemwise_imp("Sum", "add_n")


@register_importer("Mod")
def _mod_imp(g, node):
    x, y = g.inp(node["inputs"][0]), g.inp(node["inputs"][1])
    if int(node["attrs"].get("fmod", 0)):
        # fmod semantics: x - trunc(x/y)*y (sign of dividend)
        return _make("subtract", x,
                     _make("multiply", _make("trunc", _make("divide", x, y)),
                           y))
    return _make("mod", x, y)


def _reduce_lp(ordv):
    def imp(g, node):
        a = node["attrs"]
        axes = a.get("axes")
        if axes is None and len(node["inputs"]) > 1:
            # opset>=18 moved ReduceL1/L2 axes to a second input, like
            # ReduceSum at 13 — resolve through the same initializer path
            ax_init = g.initializers.get(node["inputs"][1])
            if ax_init is None:
                raise ValueError("%s: dynamic axes input unsupported"
                                 % node["op"])
            axes = [int(x) for x in np.asarray(ax_init).reshape(-1)]
        kw = {"ord": ordv, "keepdims": bool(a.get("keepdims", 1))}
        if axes is not None:
            kw["axis"] = (tuple(int(x) for x in axes) if len(axes) > 1
                          else int(axes[0]))
        return _make("norm", g.inp(node["inputs"][0]), **kw)
    return imp


register_importer("ReduceL1")(_reduce_lp(1))
register_importer("ReduceL2")(_reduce_lp(2))


def _axes_attr_or_input(g, node, input_idx=1):
    """axes from the attr (opset<13/18) or a constant second input (newer
    opsets moved reduce axes to an initializer input)."""
    axes = node["attrs"].get("axes")
    if axes is None and len(node["inputs"]) > input_idx \
            and node["inputs"][input_idx]:
        ax_init = g.initializers.get(node["inputs"][input_idx])
        if ax_init is None:
            raise ValueError("%s: dynamic axes input unsupported"
                             % node["op"])
        axes = [int(x) for x in np.asarray(ax_init).reshape(-1)]
    return axes


def _axes_kw(axes, keepdims):
    # empty axes list (opset>=18 empty initializer) means reduce-all, same
    # as an absent attr — callers handle noop_with_empty_axes separately
    kw = {"keepdims": bool(keepdims)}
    if axes:
        kw["axis"] = (tuple(int(x) for x in axes) if len(axes) > 1
                      else int(axes[0]))
    return kw


def _reduce_is_noop(node, axes):
    # opset>=18: noop_with_empty_axes=1 with axes EMPTY **or absent
    # altogether** means identity (the spec's "empty" covers both); only
    # with the flag unset does missing axes mean reduce-all
    return ((axes is None or len(axes) == 0)
            and bool(node["attrs"].get("noop_with_empty_axes", 0)))


@register_importer("ReduceLogSumExp")
def _reduce_lse_imp(g, node):
    axes = _axes_attr_or_input(g, node)
    if _reduce_is_noop(node, axes):
        return _make("identity", g.inp(node["inputs"][0]))
    kw = _axes_kw(axes, node["attrs"].get("keepdims", 1))
    return _make("logsumexp", g.inp(node["inputs"][0]), **kw)


@register_importer("ReduceLogSum")
def _reduce_logsum_imp(g, node):
    axes = _axes_attr_or_input(g, node)
    if _reduce_is_noop(node, axes):
        return _make("identity", g.inp(node["inputs"][0]))
    kw = _axes_kw(axes, node["attrs"].get("keepdims", 1))
    return _make("log", _make("sum", g.inp(node["inputs"][0]), **kw))


@register_importer("ReduceSumSquare")
def _reduce_sumsq_imp(g, node):
    axes = _axes_attr_or_input(g, node)
    if _reduce_is_noop(node, axes):
        return _make("identity", g.inp(node["inputs"][0]))
    kw = _axes_kw(axes, node["attrs"].get("keepdims", 1))
    return _make("sum", _make("square", g.inp(node["inputs"][0])), **kw)


@register_importer("GatherElements")
def _gather_elements_imp(g, node):
    return _make("take_along_axis", g.inp(node["inputs"][0]),
                 g.inp(node["inputs"][1]),
                 axis=int(node["attrs"].get("axis", 0)))


def _scatter_elements_imp(g, node):
    red = node["attrs"].get("reduction", "none")
    if red not in ("none", "add", "mul"):
        raise ValueError("ScatterElements reduction %r unsupported" % red)
    return _make("scatter_elements", g.inp(node["inputs"][0]),
                 g.inp(node["inputs"][1]), g.inp(node["inputs"][2]),
                 axis=int(node["attrs"].get("axis", 0)), reduction=red)


register_importer("ScatterElements")(_scatter_elements_imp)
register_importer("Scatter")(_scatter_elements_imp)  # deprecated alias


@register_importer("Einsum")
def _einsum_imp(g, node):
    return _make("einsum", *[g.inp(i) for i in node["inputs"]],
                 equation=node["attrs"]["equation"])


@register_importer("Trilu")
def _trilu_imp(g, node):
    k = 0
    if len(node["inputs"]) > 1 and node["inputs"][1]:
        k_init = g.initializers.get(node["inputs"][1])
        if k_init is None:
            raise ValueError("Trilu: dynamic k input unsupported")
        k = int(np.asarray(k_init).reshape(()))
    return _make("trilu", g.inp(node["inputs"][0]), k=k,
                 upper=bool(node["attrs"].get("upper", 1)))


@register_importer("Celu")
def _celu_imp(g, node):
    return _make("celu", g.inp(node["inputs"][0]),
                 alpha=float(node["attrs"].get("alpha", 1.0)))


@register_importer("HardSwish")
def _hardswish_imp(g, node):
    return _make("hardswish", g.inp(node["inputs"][0]))


@register_importer("ThresholdedRelu")
def _thresholded_relu_imp(g, node):
    return _make("thresholded_relu", g.inp(node["inputs"][0]),
                 alpha=float(node["attrs"].get("alpha", 1.0)))


@register_importer("Size")
def _size_imp(g, node):
    # ONNX Size is a RANK-0 scalar; size_array returns shape (1,)
    return _make("reshape", _make("size_array", g.inp(node["inputs"][0])),
                 shape=())


@register_importer("Multinomial")
def _multinomial_imp(g, node):
    """ONNX Multinomial input is unnormalized LOG-probabilities (the TF
    lineage); sample_multinomial wants a probability simplex — softmax
    bridges exactly."""
    a = node["attrs"]
    dtype = {6: "int32", 7: "int64"}.get(int(a.get("dtype", 6)), "int32")
    return _make("sample_multinomial",
                 _make("softmax", g.inp(node["inputs"][0]), axis=-1),
                 shape=(int(a.get("sample_size", 1)),), dtype=dtype)


@register_importer("LpNormalization")
def _lp_norm_imp(g, node):
    a = node["attrs"]
    if int(a.get("p", 2)) != 2 or int(a.get("axis", -1)) != 1:
        raise ValueError("LpNormalization import: only p=2, axis=1 "
                         "(channel mode) supported")
    return _make("L2Normalization", g.inp(node["inputs"][0]), mode="channel")


@register_importer("LRN")
def _lrn_imp(g, node):
    a = node["attrs"]
    return _make("LRN", g.inp(node["inputs"][0]),
                 nsize=int(a.get("size", 5)),
                 alpha=float(a.get("alpha", 1e-4)),
                 beta=float(a.get("beta", 0.75)),
                 knorm=float(a.get("bias", 1.0)))


@register_importer("Mean")
def _mean_imp(g, node):
    ins = [g.inp(n) for n in node["inputs"]]
    s = _make("add_n", *ins)
    return s / float(len(ins))


@register_importer("HardSigmoid")
def _hard_sigmoid_imp(g, node):
    a = node["attrs"]
    return _make("hard_sigmoid", g.inp(node["inputs"][0]),
                 alpha=float(a.get("alpha", 0.2)),
                 beta=float(a.get("beta", 0.5)))


@register_importer("Expand")
def _expand_imp(g, node):
    # ONNX Expand broadcasts BIDIRECTIONALLY (out = broadcast(x, shape),
    # where x dims may exceed a 1 in shape) — multiply by ones(shape), which
    # has exactly those semantics; broadcast_to would reject such shapes
    if node["inputs"][1] not in g.initializers:
        src = g.inp(node["inputs"][1])
        if src._op == "_onnx_shape":
            # Expand(x, Shape(y)): mul by ones_like(y) keeps ONNX Expand's
            # BIDIRECTIONAL broadcast (x dims may exceed a 1 in the target)
            return _make("broadcast_mul", g.inp(node["inputs"][0]),
                         _make("ones_like", src._inputs[0]))
    shape = tuple(int(v) for v in g.const_value(node["inputs"][1]))
    ones = var(node["outputs"][0] + "_expand_ones")
    g.initializers[ones.name] = np.ones(shape, np.float32)
    g.used_params.add(ones.name)
    return _make("broadcast_mul", g.inp(node["inputs"][0]), ones)


@register_importer("Tile")
def _tile_imp(g, node):
    reps = tuple(int(v) for v in g.const_value(node["inputs"][1]))
    return _make("tile", g.inp(node["inputs"][0]), reps=reps)


@register_importer("GridSample")
def _grid_sample_imp(g, node):
    a = node["attrs"]
    mode = a.get("mode", "bilinear")
    if mode not in ("bilinear", "linear"):
        raise ValueError("GridSample import: mode %r unsupported" % mode)
    if a.get("padding_mode", "zeros") != "zeros":
        raise ValueError("GridSample import: padding_mode %r unsupported"
                         % a.get("padding_mode"))
    if not int(a.get("align_corners", 0)):
        # BilinearSampler's corner mapping IS align_corners=1; the default
        # (half-pixel) mapping would shift every sample
        raise ValueError("GridSample import: align_corners=0 unsupported")
    grid = _make("transpose", g.inp(node["inputs"][1]), axes=(0, 3, 1, 2))
    return _make("BilinearSampler", g.inp(node["inputs"][0]), grid)


@register_importer("RoiAlign")
def _roi_align_imp(g, node):
    """sampling_ratio=0 (the spec's adaptive mode) is approximated with a
    fixed 2x2 sample grid per bin — the common producer setting; exact for
    ROIs up to 2x the pooled size."""
    a = node["attrs"]
    if a.get("mode", "avg") != "avg":
        raise ValueError("RoiAlign import: only mode='avg'")
    # the ABSENT-attr default flipped at opset 16: 'output_half_pixel'
    # before, 'half_pixel' (pixel-center offset) from 16 on
    default_ctm = "half_pixel" if g.opset >= 16 else "output_half_pixel"
    ctm = a.get("coordinate_transformation_mode", default_ctm)
    if ctm != "output_half_pixel":
        # the kernel's grid has no -0.5 pixel-center offset; importing a
        # 'half_pixel' model would shift every ROI feature by half a pixel
        raise ValueError("RoiAlign import: coordinate_transformation_mode="
                         "%r unsupported (only 'output_half_pixel')" % ctm)
    data = g.inp(node["inputs"][0])
    boxes = g.inp(node["inputs"][1])
    bidx = g.inp(node["inputs"][2])
    bcol = _make("reshape", _make("cast", bidx, dtype="float32"),
                 shape=(-1, 1))
    rois5 = _make("concat", bcol, boxes, dim=1)
    return _make("ROIAlign", data, rois5,
                 pooled_size=(int(a["output_height"]),
                              int(a["output_width"])),
                 spatial_scale=float(a.get("spatial_scale", 1.0)),
                 sample_ratio=int(a.get("sampling_ratio", 2)) or 2)


@register_importer("Range")
def _range_imp(g, node):
    start, limit, delta = (float(g.const_value(n)) for n in node["inputs"])
    vals = np.arange(start, limit, delta)
    s = var(node["outputs"][0])
    g.initializers[node["outputs"][0]] = vals
    g.used_params.add(node["outputs"][0])
    return s


def _reg_arg_imp(onnx_name, op):
    @register_importer(onnx_name)
    def imp(g, node, _op=op):
        a = node["attrs"]
        # registry argmax/argmin honor keepdims directly
        return _make(_op, g.inp(node["inputs"][0]),
                     axis=int(a.get("axis", 0)),
                     keepdims=bool(int(a.get("keepdims", 1))))


_reg_arg_imp("ArgMax", "argmax")
_reg_arg_imp("ArgMin", "argmin")


@register_importer("TopK")
def _topk_imp(g, node):
    k = int(_scalar(g.const_value(node["inputs"][1])))
    a = node["attrs"]
    out = _make("topk", g.inp(node["inputs"][0]), k=k,
                axis=int(a.get("axis", -1)), ret_typ="both",
                is_ascend=not int(a.get("largest", 1)))
    return [out[0], out[1]]


@register_importer("Split")
def _split_imp(g, node):
    a = node["attrs"]
    axis = int(a.get("axis", 0))
    n_out = len(node["outputs"])
    if len(node["inputs"]) > 1 or "split" in a:
        sizes = (tuple(int(v) for v in g.const_value(node["inputs"][1]))
                 if len(node["inputs"]) > 1
                 else tuple(int(v) for v in a["split"]))
        if len(set(sizes)) != 1:
            raise ValueError("Split import: unequal split sizes %r not "
                             "supported" % (sizes,))
    out = _make("split", g.inp(node["inputs"][0]), num_outputs=n_out,
                axis=axis)
    return [out[i] for i in range(n_out)]


@register_importer("Pad")
def _pad_imp(g, node):
    a = node["attrs"]
    mode = a.get("mode", b"constant")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    if mode not in ("constant", "edge", "reflect"):
        # the registry pad op would silently fall through to reflect
        raise ValueError("Pad import: mode %r not supported" % (mode,))
    pads = (tuple(int(v) for v in g.const_value(node["inputs"][1]))
            if len(node["inputs"]) > 1
            else tuple(int(v) for v in a.get("pads", ())))
    n = len(pads) // 2
    # ONNX: [x1_begin.. xn_begin, x1_end.. xn_end] → MXNet flat interleave
    # (b0, e0, b1, e1, ...) — the registry pad op's layout
    pad_width = tuple(v for i in range(n) for v in (pads[i], pads[n + i]))
    cval = (float(_scalar(g.const_value(node["inputs"][2])))
            if len(node["inputs"]) > 2 else 0.0)
    return _make("pad", g.inp(node["inputs"][0]), mode=mode,
                 pad_width=pad_width, constant_value=cval)


@register_importer("InstanceNormalization")
def _instancenorm_imp(g, node):
    eps = float(node["attrs"].get("epsilon", 1e-5))
    return _make("InstanceNorm", g.inp(node["inputs"][0]),
                 g.inp(node["inputs"][1]), g.inp(node["inputs"][2]),
                 eps=eps)


@register_importer("SpaceToDepth")
def _space_to_depth_imp(g, node):
    bs = int(node["attrs"]["blocksize"])
    return _make("space_to_depth", g.inp(node["inputs"][0]), block_size=bs)


@register_importer("DepthToSpace")
def _depth_to_space_imp(g, node):
    bs = int(node["attrs"]["blocksize"])
    mode = node["attrs"].get("mode", b"DCR")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    if mode != "DCR":
        raise ValueError("DepthToSpace import: only DCR mode supported")
    return _make("depth_to_space", g.inp(node["inputs"][0]), block_size=bs)


@register_importer("OneHot")
def _one_hot_imp(g, node):
    axis = int(node["attrs"].get("axis", -1))
    if axis != -1:
        # registry one_hot always places the hot dim LAST; silently wrong
        # shapes are worse than failing
        raise ValueError("OneHot import: axis=%d not supported (only -1)"
                         % axis)
    depth = int(_scalar(g.const_value(node["inputs"][1])))
    vals = g.const_value(node["inputs"][2])
    off, on = float(vals[0]), float(vals[1])
    return _make("one_hot", g.inp(node["inputs"][0]), depth=depth,
                 on_value=on, off_value=off)


@register_importer("CumSum")
def _cumsum_imp(g, node):
    axis = int(_scalar(g.const_value(node["inputs"][1])))
    a = node["attrs"]
    if int(a.get("exclusive", 0)) or int(a.get("reverse", 0)):
        raise ValueError("CumSum import: exclusive/reverse not supported")
    return _make("cumsum", g.inp(node["inputs"][0]), axis=axis)
