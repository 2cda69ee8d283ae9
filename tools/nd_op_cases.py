"""The case table of the ``mx.nd`` ops: one entry per op, with its inputs
made from a seed with numpy, its keyword arguments, whether its gradient
is checked and its tolerance.

Two readers share it so that they cannot drift: the CPU parity tests
(``tests/test_torch_port_nd_ops*.py``), which hold each op of the port
against the JAX package's on the same inputs, and ``chip_smoke.py``'s
``phase_nd_ops``, which holds each op on the card against the same op on
the CPU. It imports neither package.

An input spec is ``F(shape, lo, hi)`` (float32 uniform), ``I(shape, lo,
hi, dtype)`` (integers), ``A(array)`` (fixed values) or ``S(value)`` (a
python scalar passed as it is). ``grad`` is True for the gradient of every
float array input, a tuple of input positions, or False. The gradient is
that of ``sum(out * w)`` over the float outputs, ``w`` drawn from the same
seed.
"""
from __future__ import annotations

import zlib
from collections import namedtuple

import numpy as np

Case = namedtuple("Case", "id op inputs kwargs grad tol")

# fp32 parity tolerance (relative, absolute): the port's op against the
# JAX package's on the CPU
TOL = (1e-5, 1e-6)
# special functions whose CPU libraries differ in the last bits
SPECIAL_TOL = (1e-4, 1e-5)
# decompositions whose vectors are defined up to sign: compared in
# absolute value
SIGN_FREE_TOL = (1e-4, 1e-5, "abs")


def F(*shape, lo=-1.0, hi=1.0):
    return ("f", shape, lo, hi)


def I(*shape, lo=0, hi=5, dtype="int32"):  # noqa: E743
    return ("i", shape, lo, hi, dtype)


def A(values, dtype="float32"):
    return ("a", np.asarray(values, dtype))


def S(value):
    return ("s", value)


def C(id, op, inputs, kwargs=None, grad=True, tol=TOL):
    return Case(id, op, tuple(inputs), dict(kwargs or {}), grad, tol)


def build(case, seed=0):
    """The case's inputs as numpy arrays (or python scalars)."""
    rng = np.random.RandomState(seed + zlib.crc32(case.id.encode()) % 10007)
    out = []
    for spec in case.inputs:
        kind = spec[0]
        if kind == "f":
            _, shape, lo, hi = spec
            out.append(rng.uniform(lo, hi, shape).astype(np.float32))
        elif kind == "i":
            _, shape, lo, hi, dt = spec
            out.append(rng.randint(lo, hi, shape).astype(dt))
        elif kind == "a":
            out.append(spec[1].copy())
        else:
            out.append(spec[1])
    return out


def head_weights(case, shapes, seed=0):
    """The weights w of the loss sum(out * w), one per float output."""
    rng = np.random.RandomState(seed + 1 + zlib.crc32(case.id.encode())
                                % 10007)
    return [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]


def grad_positions(case, inputs):
    """The input positions whose gradient the case checks."""
    floats = [i for i, x in enumerate(inputs)
              if isinstance(x, np.ndarray) and x.dtype.kind == "f"]
    if case.grad is True:
        return floats
    if not case.grad:
        return []
    return [i for i in case.grad if i in floats]




def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _is_float(name):
    return name in ("float16", "bfloat16", "float32", "float64")


def run_case(nd, autograd, case, make, seed=0, grads=True):
    """(outputs, input values after the call, gradients) of ``case``
    through one package's ``nd`` (``make(x)`` makes its array from a numpy
    array), each a list of (dtype name, numpy values: float32 for a float
    dtype)."""
    inputs = build(case, seed)
    arrs = [make(x) if isinstance(x, np.ndarray) else x for x in inputs]
    pos = grad_positions(case, inputs) if grads else []
    for i in pos:
        arrs[i].attach_grad()
    fn = getattr(nd, case.op)
    if pos:
        with autograd.record():
            outs = _flat(fn(*arrs, **case.kwargs))
            fouts = [o for o in outs if _is_float(o.dtype.name)]
            ws = head_weights(case, [o.shape for o in fouts], seed)
            heads = [make(w).astype(o.dtype.name) for w, o in zip(ws, fouts)]
        autograd.backward(fouts, heads)
    else:
        outs = _flat(fn(*arrs, **case.kwargs))

    def val(a):
        v = a.asnumpy()
        return a.dtype.name, (np.asarray(v, np.float32)
                              if _is_float(a.dtype.name) else v)

    return ([val(o) for o in outs],
            [val(a) for a in arrs if hasattr(a, "asnumpy")],
            [val(arrs[i].grad) for i in pos])


def writes_inputs(op):
    """MXNet's in-place ops: the optimizer updates (``*_update*``) write
    their states back, ``onehot_encode`` writes its ``out``. Every other
    op leaves its inputs as they were."""
    return "_update" in op or op == "onehot_encode"


def assert_inputs_kept(case, after, seed=0):
    """The input arrays after the call (``run_case``'s second list) equal
    the case's inputs, bit for bit, unless the op writes its inputs by
    design."""
    if writes_inputs(case.op):
        return
    inputs = [x for x in build(case, seed) if isinstance(x, np.ndarray)]
    assert len(after) == len(inputs), case.id
    for k, (x, (_, v)) in enumerate(zip(inputs, after)):
        np.testing.assert_array_equal(
            v, x.astype(v.dtype), err_msg="%s wrote into its input %d"
            % (case.id, k))


def assert_same(got, want, tol, what):
    """Equal dtype names; floats within (rtol, atol) (or their absolute
    values, for a sign-free tolerance); others exact."""
    assert len(got) == len(want), what
    for k, ((gd, gv), (wd, wv)) in enumerate(zip(got, want)):
        assert gd == wd, "%s[%d]: dtype %s != %s" % (what, k, gd, wd)
        assert gv.shape == wv.shape, "%s[%d]: shape %s != %s" % (
            what, k, gv.shape, wv.shape)
        if _is_float(gd):
            if len(tol) > 2 and tol[2] == "abs":
                gv, wv = np.abs(gv), np.abs(wv)
            np.testing.assert_allclose(gv, wv, rtol=tol[0], atol=tol[1],
                                       err_msg="%s[%d]" % (what, k))
        else:
            np.testing.assert_array_equal(gv, wv, err_msg="%s[%d]" % (
                what, k))


_ANY = F(3, 4, lo=-2, hi=2)
_POS = F(3, 4, lo=0.5, hi=3)
_UNIT = F(3, 4, lo=-0.9, hi=0.9)
_AWAY = F(3, 4, lo=0.3, hi=2)

CASES = []
_add = CASES.append

# ---- elementwise, one input
for name in ("abs", "sign", "exp", "expm1", "square", "negative", "sin",
             "cos", "arctan", "sinh", "cosh", "tanh", "arcsinh", "degrees",
             "radians", "erf", "sigmoid", "softsign", "relu", "softrelu",
             "relu6", "log_sigmoid", "mish", "identity", "hard_sigmoid",
             "hardswish", "celu", "thresholded_relu"):
    _add(C(name, name, [_ANY], grad=name != "sign"))
_add(C("tan", "tan", [_UNIT]))
for name in ("log", "log1p", "log2", "log10", "sqrt", "rsqrt"):
    _add(C(name, name, [_POS]))
for name in ("gammaln", "gamma", "digamma"):
    _add(C(name, name, [_POS], tol=SPECIAL_TOL))
_add(C("polygamma", "polygamma", [S(1), _POS], tol=SPECIAL_TOL))
for name in ("arcsin", "arccos", "arctanh"):
    _add(C(name, name, [_UNIT]))
_add(C("erfinv", "erfinv", [_UNIT], tol=SPECIAL_TOL))
_add(C("arccosh", "arccosh", [F(3, 4, lo=1.2, hi=3)]))
for name in ("cbrt", "rcbrt", "reciprocal"):
    _add(C(name, name, [_AWAY]))
for name in ("ceil", "floor", "trunc", "round", "rint", "fix"):
    _add(C(name, name, [F(3, 4, lo=-3, hi=3)], grad=False))
    _add(C(name + "_int", name, [I(3, 4, lo=-5, hi=5)], grad=False))
for name in ("logical_not", "isnan", "isinf", "isfinite"):
    _add(C(name, name, [A([[0.0, 1.5, np.inf], [np.nan, -np.inf, -2.0]])],
           grad=False))
_add(C("abs_int", "abs", [I(3, 4, lo=-5, hi=5)], grad=False))
_add(C("square_int", "square", [I(3, 4, lo=-5, hi=5)], grad=False))
_add(C("sqrt_int", "sqrt", [I(3, 4, lo=0, hi=9)], grad=False))
_add(C("clip", "clip", [_ANY, S(-0.5), S(0.7)]))
_add(C("cast", "cast", [_ANY], {"dtype": "int32"}, grad=False))
_add(C("Cast", "Cast", [_ANY], {"dtype": "float16"}, grad=False))
_add(C("amp_cast", "amp_cast", [_ANY], {"dtype": "bfloat16"}, grad=False))
_add(C("hard_sigmoid_args", "hard_sigmoid", [_ANY],
       {"alpha": 0.3, "beta": 0.4}))
_add(C("celu_alpha", "celu", [_ANY], {"alpha": 0.5}))
_add(C("thresholded_relu_alpha", "thresholded_relu", [_ANY], {"alpha": 0.3}))
_add(C("smooth_l1", "smooth_l1", [_ANY], {"scalar": 1.5}))

# ---- elementwise, two inputs
for name in ("add", "subtract", "multiply", "maximum", "minimum", "hypot",
             "arctan2", "elemwise_add", "elemwise_sub", "elemwise_mul"):
    _add(C(name, name, [_ANY, F(3, 4, lo=-2, hi=2)]))
_add(C("divide", "divide", [_ANY, _AWAY]))
_add(C("elemwise_div", "elemwise_div", [_ANY, _AWAY]))
_add(C("mod", "mod", [F(3, 4, lo=-5, hi=5), F(3, 4, lo=0.7, hi=2)]))
_add(C("mod_neg_divisor", "mod", [F(3, 4, lo=-5, hi=5),
                                  F(3, 4, lo=-2, hi=-0.7)]))
_add(C("mod_int", "mod", [I(3, 4, lo=-9, hi=9), A([[2, -3, 4, -5]] * 3,
                                                  "int32")], grad=False))
_add(C("power", "power", [_POS, F(3, 4, lo=-1.5, hi=1.5)]))
_add(C("power_int", "power", [I(3, 4, lo=-3, hi=4), I(3, 4, lo=0, hi=3)],
       grad=False))
_add(C("add_scalar", "add", [_ANY, S(1.5)]))
_add(C("rsub_scalar", "subtract", [S(2.0), _ANY]))
_add(C("rdiv_scalar", "divide", [S(2.0), _AWAY]))
_add(C("add_int", "add", [I(3, 4, lo=-5, hi=5), I(3, 4, lo=-5, hi=5)],
       grad=False))
_add(C("divide_int", "divide", [I(3, 4, lo=-5, hi=5), I(3, 4, lo=1, hi=4)],
       grad=False))
for name in ("broadcast_add", "broadcast_sub", "broadcast_mul",
             "broadcast_maximum", "broadcast_minimum", "broadcast_hypot"):
    _add(C(name, name, [_ANY, F(1, 4, lo=-2, hi=2)]))
_add(C("broadcast_div", "broadcast_div", [_ANY, F(3, 1, lo=0.5, hi=2)]))
_add(C("broadcast_mod", "broadcast_mod", [F(3, 4, lo=-5, hi=5),
                                          F(1, 4, lo=0.7, hi=2)]))
_add(C("broadcast_power", "broadcast_power", [_POS, F(1, 4)]))
_CMP = A([[1.0, 2.0, 3.0, 4.0], [4.0, 3.0, 2.0, 1.0], [0.0, 2.0, 0.0, 2.0]])
_CMP2 = A([[1.0, 3.0, 3.0, 0.0], [0.0, 3.0, 5.0, 1.0], [0.0, 0.0, 0.0, 0.0]])
for name in ("equal", "not_equal", "greater", "greater_equal", "lesser",
             "lesser_equal", "logical_and", "logical_or", "logical_xor"):
    _add(C(name, name, [_CMP, _CMP2], grad=False))
    _add(C("broadcast_" + name, "broadcast_" + name,
           [_CMP, A([[1.0, 0.0, 3.0, 2.0]])], grad=False))
_add(C("equal_int", "equal", [I(3, 4, lo=0, hi=3), I(3, 4, lo=0, hi=3)],
       grad=False))
_add(C("greater_scalar", "greater", [_CMP, S(2.0)], grad=False))
_add(C("where", "where", [A([[1, 0, 1, 0]] * 3), _ANY, F(3, 4)],
       grad=(1, 2)))

# ---- reductions
for name in ("sum", "mean", "max", "min", "prod", "nansum", "nanprod", "var",
             "std", "sum_axis", "max_axis", "min_axis"):
    _add(C(name, name, [F(2, 3, 4, lo=0.5, hi=1.5)]))
    _add(C(name + "_axis1", name, [F(2, 3, 4, lo=0.5, hi=1.5)],
           {"axis": 1}))
    _add(C(name + "_axes_keep", name, [F(2, 3, 4, lo=0.5, hi=1.5)],
           {"axis": (0, 2), "keepdims": True}))
_add(C("nansum_nan", "nansum", [A([[1.0, np.nan, 2.0], [np.nan, 3.0, 4.0]])],
       {"axis": 1}, grad=False))
_add(C("nanprod_nan", "nanprod", [A([[1.5, np.nan, 2.0], [np.nan, 3.0, 4.0]])],
       {"axis": 1}, grad=False))
_add(C("sum_int", "sum", [I(3, 4, lo=-5, hi=5)], {"axis": 1}, grad=False))
_add(C("prod_int", "prod", [I(3, 4, lo=-3, hi=3)], {"axis": 0}, grad=False))
_add(C("max_ties", "max", [A([[1.0, 3.0, 3.0], [2.0, 2.0, 1.0]])],
       {"axis": 1}))
for name in ("argmax", "argmin"):
    _add(C(name, name, [_ANY], {"axis": 1}, grad=False))
    _add(C(name + "_flat", name, [_ANY], grad=False))
    _add(C(name + "_keep", name, [_ANY], {"axis": 0, "keepdims": True},
           grad=False))
    _add(C(name + "_ties", name, [A([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0]])],
           {"axis": 1}, grad=False))
_add(C("argmax_channel", "argmax_channel", [F(2, 5, 3)], grad=False))
_add(C("norm", "norm", [_ANY]))
_add(C("norm_l1_axis", "norm", [_ANY], {"ord": 1, "axis": 1}))
_add(C("norm_l2_keep", "norm", [_ANY], {"axis": 0, "keepdims": True}))
_add(C("cumsum", "cumsum", [_ANY], {"axis": 1}))
_add(C("cumsum_flat", "cumsum", [_ANY]))
_add(C("cumsum_int", "cumsum", [I(3, 4, lo=-3, hi=4)], {"axis": 0},
       grad=False))
_add(C("cumprod", "cumprod", [F(3, 4, lo=0.5, hi=1.5)], {"axis": 1}))
_add(C("logsumexp", "logsumexp", [_ANY], {"axis": 1}))
_add(C("logsumexp_all", "logsumexp", [_ANY], {"keepdims": True}))
_add(C("moments", "moments", [F(2, 3, 4)], {"axes": (0, 2)}))
for mode in ("instance", "channel", "spatial"):
    _add(C("L2Normalization_" + mode, "L2Normalization", [F(2, 3, 4)],
           {"mode": mode}))
_TIES = A([[3.0, 1.0, 3.0, 2.0, 1.0], [0.5, 0.5, 0.5, 2.0, -1.0]])
for kw in ({"k": 2}, {"k": 3, "ret_typ": "value"},
           {"k": 2, "ret_typ": "both", "is_ascend": True},
           {"k": 1, "axis": 0, "ret_typ": "both"}):
    _add(C("topk_" + "_".join("%s%s" % kv for kv in kw.items()), "topk",
           [_TIES], kw, grad=kw.get("ret_typ") == "value"))
_add(C("topk_rand", "topk", [F(4, 6)], {"k": 3, "ret_typ": "value"}))
_add(C("sort", "sort", [_TIES]))
_add(C("sort_desc", "sort", [F(4, 6)], {"is_ascend": False, "axis": 0}))
_add(C("argsort", "argsort", [_TIES], grad=False))
_add(C("argsort_desc", "argsort", [_TIES], {"is_ascend": False},
       grad=False))
_add(C("argsort_int32", "argsort", [F(4, 6)], {"dtype": "int32"},
       grad=False))

# ---- shape and index ops
_X = F(2, 3, 4)
_add(C("reshape", "reshape", [_X], {"shape": (0, -1)}))
_add(C("reshape_full", "reshape", [_X], {"shape": (4, 6)}))
_add(C("Reshape", "Reshape", [_X], {"shape": (-1, 0)}))
_add(C("flatten", "flatten", [_X]))
_add(C("Flatten", "Flatten", [_X]))
_add(C("transpose", "transpose", [_X]))
_add(C("transpose_axes", "transpose", [_X], {"axes": (1, 0, 2)}))
_add(C("swapaxes", "swapaxes", [_X], {"dim1": 0, "dim2": 2}))
_add(C("SwapAxis", "SwapAxis", [_X], {"dim1": 1, "dim2": 2}))
_add(C("expand_dims", "expand_dims", [_X], {"axis": 1}))
_add(C("squeeze", "squeeze", [F(2, 1, 4)], {"axis": 1}))
_add(C("squeeze_all", "squeeze", [F(1, 3, 1)]))
_add(C("broadcast_to", "broadcast_to", [F(1, 3, 1)], {"shape": (2, 0, 4)}))
_add(C("broadcast_like", "broadcast_like", [F(1, 3, 1), F(2, 3, 4)],
       grad=(0,)))
_add(C("broadcast_axis", "broadcast_axis", [F(1, 3, 1)],
       {"axis": (0, 2), "size": (2, 4)}))
_add(C("broadcast_axes", "broadcast_axes", [F(3, 1)],
       {"axis": 1, "size": 5}))
_add(C("tile", "tile", [F(2, 3)], {"reps": (2, 1, 2)}))
_add(C("repeat", "repeat", [F(2, 3)], {"repeats": 2, "axis": 1}))
_add(C("repeat_flat", "repeat", [F(2, 3)], {"repeats": 3}))
_add(C("flip", "flip", [_X], {"axis": 1}))
_add(C("flip_axes", "flip", [_X], {"axis": (0, 2)}))
_add(C("reverse", "reverse", [_X], {"axis": 2}))
_add(C("concat", "concat", [F(2, 3), F(2, 2)], {"dim": 1}))
_add(C("Concat", "Concat", [F(2, 3), F(1, 3)], {"dim": 0}))
_add(C("stack", "stack", [F(2, 3), F(2, 3)], {"axis": 1}))
_add(C("split", "split", [F(2, 6)], {"num_outputs": 3, "axis": 1}))
_add(C("split_squeeze", "split", [F(2, 3, 4)],
       {"num_outputs": 3, "axis": 1, "squeeze_axis": True}))
_add(C("SliceChannel", "SliceChannel", [F(4, 3)],
       {"num_outputs": 2, "axis": 0}))
_add(C("slice", "slice", [F(4, 5, 6)],
       {"begin": (1, 0, 2), "end": (3, 5, 6), "step": (1, 2, 1)}))
_add(C("slice_neg_step", "slice", [F(4, 5)],
       {"begin": (3, None), "end": (0, None), "step": (-1, None)}))
_add(C("crop", "crop", [F(4, 5)], {"begin": (1, 1), "end": (3, 4)}))
_add(C("slice_axis", "slice_axis", [F(4, 5)],
       {"axis": 1, "begin": 1, "end": -1}))
_add(C("slice_axis_none", "slice_axis", [F(4, 5)],
       {"axis": 0, "begin": 2, "end": None}))
_add(C("slice_like", "slice_like", [F(4, 5), F(2, 3)], grad=(0,)))
_add(C("slice_like_axes", "slice_like", [F(4, 5), F(2, 3)], {"axes": (1,)},
       grad=(0,)))
_add(C("take", "take", [F(5, 3), A([[0, 4], [2, 9]], "int32")]))
_add(C("take_wrap", "take", [F(5, 3), A([-1, 7, 2], "int32")],
       {"mode": "wrap", "axis": 0}))
_add(C("take_axis1", "take", [F(3, 5), A([1, 3], "int32")], {"axis": 1}))
_add(C("pick", "pick", [F(3, 5), A([0, 4, 2], "float32")], grad=(0,)))
_add(C("pick_axis0_keep", "pick", [F(3, 5), A([0, 2, 1, 1, 0])],
       {"axis": 0, "keepdims": True}, grad=(0,)))
_add(C("choose_element_0index", "choose_element_0index",
       [F(3, 5), A([1, 4, 0])], grad=(0,)))
_add(C("fill_element_0index", "fill_element_0index",
       [F(3, 5), F(3), A([1, 4, 0])], grad=(0, 1)))
_add(C("batch_take", "batch_take", [F(3, 5), A([1, 4, 0], "int32")],
       grad=(0,)))
_add(C("gather_nd", "gather_nd", [F(3, 4, 2), A([[0, 2, 1], [3, 0, 1]],
                                                "int32")], grad=(0,)))
_add(C("scatter_nd", "scatter_nd", [F(3, 2), A([[0, 2, 1], [3, 0, 1]],
                                               "int32")],
       {"shape": (3, 4, 2)}, grad=(0,)))
_add(C("one_hot", "one_hot", [A([0, 3, -1, 5, 2], "int32")], {"depth": 4},
       grad=False))
_add(C("one_hot_values", "one_hot", [A([[1, 0], [2, 3]], "float32")],
       {"depth": 3, "on_value": 2.0, "off_value": -1.0}, grad=False))
_add(C("diag", "diag", [F(4, 4)]))
_add(C("diag_k", "diag", [F(3, 4)], {"k": 1}))
_add(C("diag_vec", "diag", [F(3)], {"k": -1}))
_add(C("diag_3d", "diag", [F(3, 3, 2)]))
_add(C("trace", "trace", [F(4, 4)]))
_add(C("trace_offset", "trace", [F(2, 3, 3)],
       {"offset": 1, "axis1": 1, "axis2": 2}))
_add(C("depth_to_space", "depth_to_space", [F(1, 8, 2, 3)],
       {"block_size": 2}))
_add(C("space_to_depth", "space_to_depth", [F(1, 2, 4, 6)],
       {"block_size": 2}))
_add(C("zeros_like", "zeros_like", [_X], grad=False))
_add(C("ones_like", "ones_like", [_X], grad=False))
_add(C("shape_array", "shape_array", [_X], grad=False))
_add(C("size_array", "size_array", [_X], grad=False))
_add(C("_onnx_shape", "_onnx_shape", [_X], grad=False))
_add(C("reshape_like", "reshape_like", [F(2, 6), F(3, 4)], grad=(0,)))
_add(C("take_along_axis", "take_along_axis",
       [F(3, 4), A([[0, 3], [1, 1], [2, 0]], "int32")], {"axis": 1},
       grad=(0,)))
_add(C("scatter_elements", "scatter_elements",
       [F(3, 4), A([[0, 3], [1, 2], [2, 0]], "int32"), F(3, 2)],
       {"axis": 1}, grad=(0, 2)))
_add(C("scatter_elements_add", "scatter_elements",
       [F(3, 4), A([[0, 0], [1, 2], [2, 0]], "int32"), F(3, 2)],
       {"axis": 1, "reduction": "add"}, grad=(0, 2)))
_add(C("trilu", "trilu", [F(4, 4)]))
_add(C("trilu_lower", "trilu", [F(2, 4, 4)], {"k": -1, "upper": False}))
_add(C("unravel_index", "unravel_index", [A([0, 5, 11, 7], "int32")],
       {"shape": (3, 4)}, grad=False))
_add(C("ravel_multi_index", "ravel_multi_index",
       [A([[0, 1, 2], [3, 0, 1]], "int32")], {"shape": (3, 4)}, grad=False))
_add(C("einsum", "einsum", [F(2, 3), F(3, 4)], {"equation": "ij,jk->ik"}))
_add(C("khatri_rao", "khatri_rao", [F(2, 3), F(4, 3)]))
_add(C("im2col", "im2col", [F(1, 2, 5, 5)],
       {"kernel": (3, 3), "stride": (2, 1), "pad": (1, 0)}))
_add(C("col2im", "col2im", [F(1, 18, 9)],
       {"output_size": (5, 5), "kernel": (3, 3), "stride": (2, 2),
        "pad": (1, 1)}))
_add(C("Crop", "Crop", [F(1, 2, 5, 6)], {"h_w": (3, 4), "offset": (1, 2)}))
_add(C("Crop_like", "Crop", [F(1, 2, 5, 6), F(1, 2, 3, 3)],
       {"center_crop": True}, grad=(0,)))
_add(C("add_n", "add_n", [F(2, 3), F(2, 3), F(2, 3)]))
_add(C("ElementWiseSum", "ElementWiseSum", [F(2, 3), F(2, 3)]))
_add(C("amp_multicast", "amp_multicast",
       [F(2, 3), A([[1.0, 2.0]], "float16"), A([1, 2], "int32")],
       grad=False))
_add(C("amp_multicast_narrow", "amp_multicast",
       [F(2, 3), A([[1.0, 2.0]], "float16")], {"cast_narrow": True},
       grad=False))

# ---- products
_add(C("dot", "dot", [F(3, 4), F(4, 5)]))
_add(C("dot_t", "dot", [F(4, 3), F(5, 4)],
       {"transpose_a": True, "transpose_b": True}))
_add(C("dot_3d", "dot", [F(2, 3, 4), F(4, 5)]))
_add(C("dot_vec", "dot", [F(4), F(4)]))
_add(C("batch_dot", "batch_dot", [F(2, 3, 4), F(2, 4, 5)]))
_add(C("batch_dot_t", "batch_dot", [F(2, 4, 3), F(2, 5, 4)],
       {"transpose_a": True, "transpose_b": True}))
_add(C("matmul", "matmul", [F(2, 3, 4), F(4, 2)]))
_SPD = A(np.array([[4.0, 1.0, 0.5], [1.0, 3.0, 0.2], [0.5, 0.2, 2.0]]))
_LOW = A(np.array([[2.0, 0.0, 0.0], [0.5, 1.5, 0.0], [0.3, -0.2, 1.2]]))
_add(C("linalg_gemm2", "linalg_gemm2", [F(2, 3, 4), F(2, 4, 5)],
       {"alpha": 0.5}))
_add(C("linalg_gemm", "linalg_gemm", [F(3, 4), F(5, 4), F(3, 5)],
       {"transpose_b": True, "alpha": 2.0, "beta": 0.5}))
_add(C("linalg_potrf", "linalg_potrf", [_SPD], tol=SPECIAL_TOL))
_add(C("linalg_potri", "linalg_potri", [_LOW], tol=SPECIAL_TOL))
_add(C("linalg_det", "linalg_det", [_SPD], tol=SPECIAL_TOL))
_add(C("linalg_inverse", "linalg_inverse", [_SPD], tol=SPECIAL_TOL))
_add(C("linalg_slogdet", "linalg_slogdet", [_SPD], grad=False,
       tol=SPECIAL_TOL))
_add(C("linalg_sumlogdiag", "linalg_sumlogdiag", [_SPD]))
_add(C("linalg_extractdiag", "linalg_extractdiag", [F(2, 3, 3)],
       {"offset": 1}))
_add(C("linalg_makediag", "linalg_makediag", [F(2, 3)], {"offset": -1}))
_add(C("linalg_syrk", "linalg_syrk", [F(3, 4)], {"alpha": 2.0}))
_add(C("linalg_trmm", "linalg_trmm", [_LOW, F(3, 2)],
       {"transpose": True}))
_add(C("linalg_trmm_right", "linalg_trmm", [_LOW, F(2, 3)],
       {"rightside": True, "lower": False}))
_add(C("linalg_trsm", "linalg_trsm", [_LOW, F(3, 2)], tol=SPECIAL_TOL))
_add(C("linalg_trsm_right_t", "linalg_trsm", [_LOW, F(2, 3)],
       {"rightside": True, "transpose": True, "alpha": 2.0},
       tol=SPECIAL_TOL))
_add(C("linalg_gelqf", "linalg_gelqf", [F(2, 4)], grad=False,
       tol=SIGN_FREE_TOL))
_add(C("linalg_extracttrian", "linalg_extracttrian", [F(3, 3)],
       {"offset": 1}))
_add(C("linalg_extracttrian_upper", "linalg_extracttrian", [F(2, 3, 3)],
       {"lower": False}))
_add(C("linalg_maketrian", "linalg_maketrian", [F(2, 6)]))
_add(C("linalg_maketrian_neg", "linalg_maketrian", [F(3)], {"offset": -1}))
_add(C("linalg_syevd", "linalg_syevd", [_SPD], grad=False,
       tol=SIGN_FREE_TOL))

# ---- nn
_add(C("FullyConnected", "FullyConnected", [F(4, 6), F(5, 6), F(5)],
       {"num_hidden": 5}))
_add(C("FullyConnected_flatten", "FullyConnected", [F(2, 3, 4), F(5, 12)],
       {"num_hidden": 5, "no_bias": True}))
_add(C("Embedding", "Embedding", [A([[0, 3], [5, 3]], "int32"), F(6, 4)],
       {"input_dim": 6, "output_dim": 4}))
_add(C("LayerNorm", "LayerNorm", [F(4, 6), F(6, lo=0.5, hi=1.5), F(6)]))
_add(C("LayerNorm_3d", "LayerNorm", [F(2, 3, 6), F(6, lo=0.5, hi=1.5),
                                     F(6)], {"eps": 1e-3}))
_add(C("Dropout_predict", "Dropout", [_X], {"p": 0.5}, grad=False))
for act in ("relu", "sigmoid", "tanh", "softrelu", "softsign", "gelu",
            "gelu_tanh", "swish", "silu", "relu6"):
    _add(C("Activation_" + act, "Activation", [_ANY], {"act_type": act}))
for act, kw in (("leaky", {"slope": 0.1}), ("elu", {"slope": 0.7}),
                ("selu", {}), ("gelu", {})):
    _add(C("LeakyReLU_" + act, "LeakyReLU", [_ANY],
           dict(act_type=act, **kw)))
_add(C("LeakyReLU_prelu", "LeakyReLU", [F(2, 3, 4), F(3)],
       {"act_type": "prelu"}))
_add(C("softmax", "softmax", [_X]))
_add(C("softmax_axis_temp", "softmax", [_X], {"axis": 1,
                                              "temperature": 2.0}))
_add(C("log_softmax", "log_softmax", [_X], {"axis": 1}))
_add(C("softmin", "softmin", [_X], {"temperature": 0.5}))
_add(C("SoftmaxActivation", "SoftmaxActivation", [_X]))
_add(C("SoftmaxActivation_channel", "SoftmaxActivation", [_X],
       {"mode": "channel"}))
_add(C("masked_softmax", "masked_softmax",
       [F(2, 4), A([[1, 1, 0, 1], [0, 1, 1, 1]])], grad=(0,)))
_add(C("softmax_with_length", "softmax_with_length",
       [F(2, 5), A([3, 5], "int32")], grad=(0,)))
_add(C("softmax_cross_entropy", "softmax_cross_entropy",
       [F(4, 7), A([0, 6, 3, 2], "int32")], grad=(0,)))
_add(C("softmax_xent_rows", "softmax_xent_rows",
       [F(2, 3, 7), A([[0, 6, 3], [2, 1, 1]], "int32")], grad=(0,)))
_add(C("SoftmaxOutput", "SoftmaxOutput", [F(3, 5), A([1, 0, 4])],
       grad=(0,)))
_add(C("Softmax", "Softmax", [F(3, 5), A([1, 0, 4])], grad=(0,)))
for name in ("LinearRegressionOutput", "MAERegressionOutput",
             "LogisticRegressionOutput"):
    _add(C(name, name, [F(4, 3), F(4, 3)], {"grad_scale": 2.0},
           grad=(0,)))
_add(C("SVMOutput", "SVMOutput", [F(4, 3), A([0, 2, 1, 2])],
       {"margin": 0.5}, grad=(0,)))
_add(C("SVMOutput_linear", "SVMOutput", [F(4, 3), A([0, 2, 1, 2])],
       {"use_linear": True, "regularization_coefficient": 0.5}, grad=(0,)))
_add(C("MakeLoss", "MakeLoss", [F(4, 3)], {"grad_scale": 0.5}))
_add(C("MakeLoss_batch", "MakeLoss", [F(4, 3)],
       {"normalization": "batch"}))
_add(C("MakeLoss_valid", "MakeLoss", [F(4, 3)],
       {"normalization": "valid", "valid_thresh": 0.1}))
_add(C("IdentityAttachKLSparseReg", "IdentityAttachKLSparseReg",
       [F(4, 3, lo=0.1, hi=0.9)], {"penalty": 0.01}))
_add(C("BlockGrad", "BlockGrad", [_X]))
_add(C("stop_gradient", "stop_gradient", [_X]))
_SEQ = F(5, 3, 2)
_LEN = A([2, 5, 1], "float32")
_add(C("SequenceMask", "SequenceMask", [_SEQ, _LEN],
       {"use_sequence_length": True, "value": -1.0}, grad=(0,)))
_add(C("SequenceMask_axis1", "SequenceMask", [F(3, 5, 2), _LEN],
       {"use_sequence_length": True, "axis": 1}, grad=(0,)))
_add(C("SequenceMask_off", "SequenceMask", [_SEQ]))
_add(C("SequenceLast", "SequenceLast", [_SEQ, _LEN],
       {"use_sequence_length": True}, grad=(0,)))
_add(C("SequenceLast_off", "SequenceLast", [_SEQ]))
_add(C("SequenceReverse", "SequenceReverse", [_SEQ, _LEN],
       {"use_sequence_length": True}, grad=(0,)))
_add(C("SequenceReverse_off", "SequenceReverse", [_SEQ]))
_IMG = F(2, 3, 5, 6)
_add(C("LRN", "LRN", [F(2, 6, 3, 3, lo=0, hi=2)], {"nsize": 3}))
_add(C("UpSampling", "UpSampling", [F(1, 2, 3, 4)], {"scale": 2}))
_add(C("UpSampling_bilinear", "UpSampling", [F(1, 2, 3, 4)],
       {"scale": 2, "sample_type": "bilinear"}))
_add(C("AdaptiveAvgPooling2D", "AdaptiveAvgPooling2D", [_IMG],
       {"output_size": (2, 4)}))
_add(C("AdaptiveAvgPooling2D_int", "AdaptiveAvgPooling2D", [_IMG],
       {"output_size": 3}))
_add(C("BilinearResize2D", "BilinearResize2D", [_IMG],
       {"height": 7, "width": 4}))
_add(C("BilinearResize2D_scale", "BilinearResize2D", [_IMG],
       {"scale_height": 2.0, "scale_width": 0.5}))
_add(C("_resize_linear_asymmetric", "_resize_linear_asymmetric", [_IMG],
       {"scale_height": 2.0, "scale_width": 1.5}))
_add(C("_resize_linear_half_pixel", "_resize_linear_half_pixel", [_IMG],
       {"height": 10, "width": 9}))
_add(C("Convolution", "Convolution", [_IMG, F(4, 3, 3, 3), F(4)],
       {"kernel": (3, 3), "num_filter": 4, "pad": 1}))
_add(C("Convolution_v1", "Convolution_v1", [_IMG, F(4, 3, 3, 3), F(4)],
       {"kernel": (3, 3), "num_filter": 4, "stride": 2}))
_add(C("Deconvolution", "Deconvolution", [_IMG, F(3, 2, 3, 3)],
       {"kernel": (3, 3), "num_filter": 2, "stride": 2, "no_bias": True}))
_add(C("Pooling", "Pooling", [_IMG], {"kernel": 2, "pool_type": "max"}))
_add(C("Pooling_v1", "Pooling_v1", [_IMG],
       {"kernel": 3, "stride": 1, "pool_type": "avg", "pad": 1}))
_add(C("BatchNorm", "BatchNorm", [_IMG, F(3), F(3), F(3), F(3, lo=0.5,
                                                             hi=1.5)],
       grad=(0, 1, 2)))
_add(C("BatchNorm_v1", "BatchNorm_v1", [_IMG, F(3), F(3), F(3),
                                        F(3, lo=0.5, hi=1.5)],
       {"training": True}, grad=(0, 1, 2)))
_add(C("InstanceNorm", "InstanceNorm", [_IMG, F(3), F(3)]))
_add(C("GroupNorm", "GroupNorm", [F(2, 4, 3, 3), F(4), F(4)],
       {"num_groups": 2}))
_add(C("pad", "pad", [_IMG],
       {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
        "constant_value": 0.5}))
_add(C("Pad", "Pad", [_IMG],
       {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 1, 2, 2)}))
_add(C("Correlation", "Correlation", [F(1, 2, 5, 5), F(1, 2, 5, 5)],
       {"max_displacement": 1, "pad_size": 1}))
_add(C("Correlation_patch", "Correlation", [F(1, 2, 5, 5), F(1, 2, 5, 5)],
       {"kernel_size": 3, "max_displacement": 2, "pad_size": 2,
        "stride2": 2, "is_multiply": False}))
_add(C("scaled_dot_attention", "scaled_dot_attention",
       [F(1, 2, 5, 8), F(1, 2, 5, 8), F(1, 2, 5, 8)], {"causal": True}))

# ---- the KV-cache writes (through nd they write into a copy), the fused
# recurrence and the detection ops
_add(C("cache_write", "cache_write", [F(2, 2, 6, 3), F(2, 2, 2, 3), S(3)],
       grad=False))
_add(C("cache_write_rows", "cache_write",
       [F(2, 2, 6, 3), F(2, 2, 1, 3), A([1, 5], "int32")], grad=False))
_QCACHE = I(2, 2, 6, 3, lo=-127, hi=128, dtype="int8")
_QSCALE = F(2, 2, 1, 1, lo=0.01, hi=0.03)
_add(C("quant_cache_write", "quant_cache_write",
       [_QCACHE, _QSCALE, F(2, 2, 1, 3, lo=-4, hi=4), S(2)], grad=False))
_add(C("quant_cache_write_read", "quant_cache_write_read",
       [_QCACHE, _QSCALE, F(2, 2, 2, 3, lo=-1, hi=1), S(4)], grad=False))


def _rnn_inputs(mode, T=4, N=2, C=3, H=3, layers=1, dirs=1):
    """x (T, N, C), h0, c0 (layers*dirs, N, H) and the weights of each
    (layer, direction): i2h_w, h2h_w, i2h_b, h2h_b."""
    G = {"lstm": 4, "gru": 3}.get(mode, 1) * H
    out = [F(T, N, C), F(layers * dirs, N, H), F(layers * dirs, N, H)]
    for layer in range(layers):
        c_in = C if layer == 0 else H * dirs
        out += [F(G, c_in), F(G, H), F(G), F(G)] * dirs
    return out


_add(C("RNN_lstm", "RNN", _rnn_inputs("lstm"), {"mode": "lstm"}))
_add(C("RNN_lstm_bi_2layer", "RNN",
       _rnn_inputs("lstm", layers=2, dirs=2),
       {"mode": "lstm", "num_layers": 2, "bidirectional": True}))
_add(C("RNN_gru_bi", "RNN", _rnn_inputs("gru", dirs=2),
       {"mode": "gru", "bidirectional": True}))
_add(C("RNN_tanh_2layer", "RNN", _rnn_inputs("rnn_tanh", layers=2),
       {"mode": "rnn_tanh", "num_layers": 2}))
_add(C("RNN_relu", "RNN", _rnn_inputs("rnn_relu"), {"mode": "rnn_relu"}))
_add(C("_rnn_init", "_rnn_init", [F(4, 2, 3)], {"num": 2, "hidden": 5},
       grad=False))


def _corner_boxes(rng, *shape):
    lo = rng.uniform(0.0, 0.6, shape + (2,))
    wh = rng.uniform(0.05, 0.4, shape + (2,))
    return np.concatenate([lo, lo + wh], -1).astype(np.float32)


_DRNG = np.random.RandomState(11)
_BOX_A, _BOX_B = _corner_boxes(_DRNG, 2, 5), _corner_boxes(_DRNG, 2, 3)
# detections [id, score, box]: eight boxes, two classes, near duplicates,
# a score tie and an invalid entry
_DET = np.concatenate([
    _DRNG.randint(0, 2, (2, 8, 1)).astype(np.float32),
    _DRNG.uniform(0.0, 1.0, (2, 8, 1)).astype(np.float32),
    _corner_boxes(_DRNG, 2, 8)], -1)
_DET[:, 3, 2:] = _DET[:, 2, 2:] + 0.01
_DET[:, 5, 1] = _DET[:, 4, 1]
_DET[0, 6, 1] = -1.0
# 36 anchors (a 3 x 3 map, 4 a pixel) and two images of ground truth: a
# padding row in each, and in the second two boxes with the same best
# anchor
_ANCH = np.array([[[cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
                   for cy in (1 / 6, 1 / 2, 5 / 6) for cx in (1 / 6, 1 / 2,
                                                                5 / 6)
                   for w, h in ((0.3, 0.3), (0.5, 0.5), (0.42, 0.21),
                                (0.21, 0.42))]], np.float32)
_LAB = np.array([[[1, 0.1, 0.1, 0.45, 0.4], [0, 0.5, 0.55, 0.95, 0.9],
                  [-1, 0, 0, 0, 0]],
                 [[2, 0.3, 0.3, 0.7, 0.72], [0, 0.31, 0.29, 0.69, 0.7],
                  [-1, 0, 0, 0, 0]]], np.float32)
_add(C("box_iou", "box_iou", [A(_BOX_A), A(_BOX_B)], grad=False))
_add(C("box_iou_center", "box_iou", [A(_BOX_A), A(_BOX_B)],
       {"format": "center"}, grad=False))
_add(C("box_nms", "box_nms", [A(_DET)],
       {"overlap_thresh": 0.3, "valid_thresh": 0.05}, grad=False))
_add(C("box_nms_force", "box_nms", [A(_DET[0])],
       {"overlap_thresh": 0.2, "force_suppress": True,
        "in_format": "center"}, grad=False))
_add(C("multibox_prior", "multibox_prior", [F(1, 3, 4, 5)],
       {"sizes": (0.3, 0.5), "ratios": (1, 2, 0.5)}, grad=False))
_add(C("multibox_prior_clip", "multibox_prior", [F(1, 3, 3, 2)],
       {"sizes": (0.9,), "ratios": (1, 3), "steps": (0.2, 0.25),
        "offsets": (0.3, 0.6), "clip": True}, grad=False))
_add(C("multibox_target", "multibox_target",
       [A(_ANCH), A(_LAB), F(2, 4, 36, lo=0.0, hi=1.0)], grad=False))
_add(C("multibox_detection", "multibox_detection",
       [F(2, 4, 36, lo=0.0, hi=1.0), F(2, 144, lo=-0.5, hi=0.5), A(_ANCH)],
       {"threshold": 0.3, "nms_threshold": 0.4}, grad=False))
_add(C("bipartite_matching", "bipartite_matching", [F(2, 4, 3)],
       {"threshold": 0.1}, grad=False))
_add(C("bipartite_matching_ascend", "bipartite_matching",
       [A([[[0.5, np.nan, 0.2], [np.inf, 0.3, -np.inf],
            [0.2, 0.9, 0.1]]])],
       {"threshold": 0.4, "is_ascend": True, "topk": 2}, grad=False))

# ---- the legacy flat ops
_add(C("all_finite", "all_finite", [A([1.0, np.inf])], grad=False))
_add(C("all_finite_ok", "all_finite", [_ANY], grad=False))
_add(C("multi_all_finite", "multi_all_finite",
       [_ANY, A([1.0, np.nan])], grad=False))
_add(C("multi_sum_sq", "multi_sum_sq", [F(3), F(2, 2)], grad=False))
_add(C("onehot_encode", "onehot_encode", [A([1, 0, 3]), F(3, 4)],
       grad=False))
_add(C("cast_storage", "cast_storage", [_ANY], {"stype": "default"},
       grad=False))
_W, _G, _M, _V = F(3, 4), F(3, 4), F(3, 4), F(3, 4, lo=0.1, hi=1)
_UPD = dict(grad=False)
_add(C("sgd_update", "sgd_update", [_W, _G],
       {"lr": 0.1, "wd": 0.01, "clip_gradient": 0.5}, **_UPD))
_add(C("sgd_mom_update", "sgd_mom_update", [_W, _G, _M],
       {"lr": 0.1, "momentum": 0.9, "wd": 0.01}, **_UPD))
_add(C("adam_update", "adam_update", [_W, _G, _M, _V],
       {"lr": 0.01, "wd": 0.01, "rescale_grad": 0.5}, **_UPD))
_add(C("lamb_update_phase1", "lamb_update_phase1", [_W, _G, _M, _V],
       {"t": 3, "wd": 0.01}, **_UPD))
_add(C("lamb_update_phase2", "lamb_update_phase2",
       [_W, _G, A([2.0]), A([0.5])], {"lr": 0.1, "lower_bound": 0.1,
                                      "upper_bound": 1.5}, **_UPD))
_add(C("mp_lamb_update_phase1", "mp_lamb_update_phase1",
       [_W, _G, _M, _V, _W], {"t": 2, "bias_correction": False}, **_UPD))
_add(C("mp_lamb_update_phase2", "mp_lamb_update_phase2",
       [_W, _G, A([2.0]), A([0.5]), _W], {"lr": 0.1}, **_UPD))
_add(C("multi_lars", "multi_lars",
       [A([0.1, 0.2]), A([4.0, 0.0]), A([1.0, 2.0]), A([0.01, 0.0])],
       {"eta": 0.001, "eps": 1e-8}, **_UPD))
_add(C("rmsprop_update", "rmsprop_update", [_W, _G, _V],
       {"lr": 0.01, "wd": 0.01}, **_UPD))
_add(C("signsgd_update", "signsgd_update", [_W, _G],
       {"lr": 0.01, "wd": 0.1}, **_UPD))
_add(C("signum_update", "signum_update", [_W, _G, _M],
       {"lr": 0.01, "momentum": 0.9, "wd_lh": 0.01}, **_UPD))
_add(C("ftrl_update", "ftrl_update", [_W, _G, _M, _V],
       {"lr": 0.1, "lamda1": 0.05}, **_UPD))
_add(C("mp_sgd_update", "mp_sgd_update", [_W, _G, _W], {"lr": 0.1},
       **_UPD))
_add(C("mp_sgd_mom_update", "mp_sgd_mom_update", [_W, _G, _M, _W],
       {"lr": 0.1, "momentum": 0.9}, **_UPD))
_add(C("nag_mom_update", "nag_mom_update", [_W, _G, _M],
       {"lr": 0.1, "momentum": 0.9, "wd": 0.01}, **_UPD))
_add(C("mp_nag_mom_update", "mp_nag_mom_update", [_W, _G, _M, _W],
       {"lr": 0.1, "momentum": 0.9}, **_UPD))
_add(C("ftml_update", "ftml_update", [_W, _G, _V, _V, _M],
       {"lr": 0.1, "t": 2}, **_UPD))
_add(C("rmspropalex_update", "rmspropalex_update", [_W, _G, _V, _M, _M],
       {"lr": 0.01, "clip_weights": 0.5}, **_UPD))
_LR, _WD = [0.1, 0.05], [0.0, 0.01]
_add(C("multi_sgd_update", "multi_sgd_update", [_W, _G, F(2), F(2)],
       {"lrs": _LR, "wds": _WD}, **_UPD))
_add(C("multi_sgd_mom_update", "multi_sgd_mom_update",
       [_W, _G, _M, F(2), F(2), F(2)],
       {"lrs": _LR, "wds": _WD, "momentum": 0.9}, **_UPD))
_add(C("multi_mp_sgd_update", "multi_mp_sgd_update",
       [_W, _G, _W, F(2), F(2), F(2)], {"lrs": _LR, "wds": _WD}, **_UPD))
_add(C("multi_mp_sgd_mom_update", "multi_mp_sgd_mom_update",
       [_W, _G, _M, _W, F(2), F(2), F(2), F(2)],
       {"lrs": _LR, "wds": _WD, "momentum": 0.9}, **_UPD))
_add(C("preloaded_multi_sgd_update", "preloaded_multi_sgd_update",
       [_W, _G, F(2), F(2), A(_LR), A(_WD)], **_UPD))
_add(C("preloaded_multi_sgd_mom_update", "preloaded_multi_sgd_mom_update",
       [_W, _G, _M, F(2), F(2), F(2), A(_LR), A(_WD)], {"momentum": 0.9},
       **_UPD))
_add(C("preloaded_multi_mp_sgd_update", "preloaded_multi_mp_sgd_update",
       [_W, _G, _W, F(2), F(2), F(2), A(_LR), A(_WD)], **_UPD))
_add(C("preloaded_multi_mp_sgd_mom_update",
       "preloaded_multi_mp_sgd_mom_update",
       [_W, _G, _M, _W, F(2), F(2), F(2), F(2), A(_LR), A(_WD)],
       {"momentum": 0.9}, **_UPD))

# the random draws: the streams cannot match JAX's; each is held to its
# distribution's moments and to itself under one seed. (op, kwargs, the
# mean and variance of one draw, or None where only the mean is known)
RANDOM_CASES = [
    ("random_uniform", {"low": -1.0, "high": 3.0}, 1.0, 16.0 / 12),
    ("uniform", {"low": 0.0, "high": 2.0}, 1.0, 4.0 / 12),
    ("random_normal", {"loc": 1.0, "scale": 2.0}, 1.0, 4.0),
    ("normal", {"loc": -1.0, "scale": 0.5}, -1.0, 0.25),
    ("random_exponential", {"lam": 2.0}, 0.5, 0.25),
    ("exponential", {"lam": 0.5}, 2.0, 4.0),
    ("random_gamma", {"alpha": 2.5, "beta": 2.0}, 5.0, 10.0),
    ("random_gamma", {"alpha": 0.5, "beta": 1.0}, 0.5, 0.5),
    ("random_poisson", {"lam": 3.0}, 3.0, 3.0),
    ("poisson", {"lam": 0.5}, 0.5, 0.5),
    ("random_negative_binomial", {"k": 3, "p": 0.4}, 4.5, 11.25),
    ("random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5},
     2.0, 4.0),
    ("random_randint", {"low": -2, "high": 5}, 1.0, 4.0),
]
# sample_* ops: (op, parameter arrays, kwargs, per-row mean, per-row var)
SAMPLE_CASES = [
    ("sample_uniform", ([0.0, 2.0], [1.0, 6.0]), {}, [0.5, 4.0],
     [1 / 12, 16 / 12]),
    ("sample_normal", ([0.0, 3.0], [1.0, 0.5]), {}, [0.0, 3.0], [1.0, 0.25]),
    ("sample_exponential", ([1.0, 4.0],), {}, [1.0, 0.25], [1.0, 1 / 16]),
    ("sample_gamma", ([2.0, 0.5], [1.0, 3.0]), {}, [2.0, 1.5], [2.0, 4.5]),
    ("sample_poisson", ([1.0, 6.0],), {}, [1.0, 6.0], [1.0, 6.0]),
    ("sample_multinomial", ([[0.2, 0.8, 0.0], [0.5, 0.25, 0.25]],), {},
     [0.8, 0.75], None),
]


def card_tol(case):
    """The card against the CPU: ten times the case's tolerance (the
    card's math library and summation orders are not the CPU's; TF32 is
    off for fp32 products)."""
    return (case.tol[0] * 10, case.tol[1] * 10) + tuple(case.tol[2:])
