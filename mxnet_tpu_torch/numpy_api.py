"""The NumPy-compatible array API, ``mx.np`` (counterpart of
``mxnet_tpu/numpy_api.py``; ref: python/mxnet/numpy/multiarray.py, MXNet
2.x's ``mx.np``).

The names wrapped here are numpy-style signatures over the registry ops
(``invoke``), as in the JAX package, and numpy's semantics written on
torch where torch's function of the name has another default or result
(``median``, ``percentile``, ``unique``, ``pad``, ``append``, ...). Other
numpy names resolve on first use (``__getattr__``): those whose torch
function takes numpy's arguments (``axis`` as ``dim``, ``keepdims`` as
``keepdim``) run it on the arrays' device (``TORCH_NAMES``,
``TORCH_ALIASES``); names of a host nature (printing, files, dtype and
shape queries) are numpy's own objects (``HOST_NAMES``), as the JAX
package's ``_ONP_HOST_NAMES`` are; any other name raises
``AttributeError``, as the JAX package does for a name ``jax.numpy``
lacks. No array goes through the host.
``linalg`` and ``fft`` are ``torch.linalg`` and ``torch.fft`` with NDArray
in and out. ``bfloat16`` is ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as _onp
import torch

from .ndarray import (NDArray, array, invoke, zeros, ones, full, arange,  # noqa: F401
                      linspace, eye)
from .nd import random  # noqa: F401

newaxis = None
pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
float32 = _onp.float32
float64 = _onp.float64
int32 = _onp.int32
int64 = _onp.int64
bfloat16 = torch.bfloat16


def _ax(fn_name):
    def f(a, axis=None, keepdims=False):
        return invoke(fn_name, (a,), {"axis": axis, "keepdims": keepdims})

    f.__name__ = fn_name
    return f


sum = _ax("sum")
mean = _ax("mean")
prod = _ax("prod")
max = _ax("max")
min = _ax("min")
var = _ax("var")
std = _ax("std")
amax = max
amin = min


def argmax(a, axis=None):
    return invoke("argmax", (a,), {"axis": axis})


def argmin(a, axis=None):
    return invoke("argmin", (a,), {"axis": axis})


def _u(fn_name):
    def f(a):
        return invoke(fn_name, (a,), {})

    f.__name__ = fn_name
    return f


abs = _u("abs")
exp = _u("exp")
expm1 = _u("expm1")
log = _u("log")
log1p = _u("log1p")
log2 = _u("log2")
log10 = _u("log10")
sqrt = _u("sqrt")
cbrt = _u("cbrt")
square = _u("square")
sign = _u("sign")
ceil = _u("ceil")
floor = _u("floor")
sin = _u("sin")
cos = _u("cos")
tan = _u("tan")
arcsin = _u("arcsin")
arccos = _u("arccos")
arctan = _u("arctan")
sinh = _u("sinh")
cosh = _u("cosh")
tanh = _u("tanh")
negative = _u("negative")
reciprocal = _u("reciprocal")


def _b(fn_name):
    def f(a, b):
        return invoke(fn_name, (a, b), {})

    f.__name__ = fn_name
    return f


add = _b("add")
subtract = _b("subtract")
multiply = _b("multiply")
divide = _b("divide")
true_divide = divide
mod = _b("mod")
power = _b("power")
maximum = _b("maximum")
minimum = _b("minimum")
hypot = _b("hypot")
arctan2 = _b("arctan2")
equal = _b("equal")
not_equal = _b("not_equal")
greater = _b("greater")
greater_equal = _b("greater_equal")
less = _b("lesser")
less_equal = _b("lesser_equal")
logical_and = _b("logical_and")
logical_or = _b("logical_or")
logical_xor = _b("logical_xor")
dot = _b("matmul")
matmul = _b("matmul")


def where(cond, x, y):
    return invoke("where", (cond, x, y), {})


def clip(a, a_min, a_max):
    return invoke("clip", (a,), {"a_min": a_min, "a_max": a_max})


def reshape(a, newshape):
    shape = (newshape,) if isinstance(newshape, int) else tuple(newshape)
    return invoke("reshape", (a,), {"shape": shape})


def transpose(a, axes=None):
    return invoke("transpose", (a,), {"axes": tuple(axes) if axes else None})


def swapaxes(a, a1, a2):
    return invoke("swapaxes", (a,), {"dim1": a1, "dim2": a2})


def expand_dims(a, axis):
    return invoke("expand_dims", (a,), {"axis": axis})


def squeeze(a, axis=None):
    return invoke("squeeze", (a,), {"axis": axis})


def concatenate(seq, axis=0):
    return invoke("concat", tuple(seq), {"dim": axis})


def stack(seq, axis=0):
    return invoke("stack", tuple(seq), {"axis": axis})


def split(a, indices_or_sections, axis=0):
    return invoke("split", (a,), {"num_outputs": indices_or_sections,
                                  "axis": axis})


def tile(a, reps):
    return invoke("tile", (a,), {"reps": reps})


def repeat(a, repeats, axis=None):
    return invoke("repeat", (a,), {"repeats": repeats, "axis": axis})


def flip(a, axis):
    return invoke("flip", (a,), {"axis": axis})


def broadcast_to(a, shape):
    return invoke("broadcast_to", (a,), {"shape": tuple(shape)})


def cumsum(a, axis=None):
    return invoke("cumsum", (a,), {"axis": axis})


def sort(a, axis=-1):
    return invoke("sort", (a,), {"axis": axis})


def argsort(a, axis=-1):
    return invoke("argsort", (a,), {"axis": axis})


def take(a, indices, axis=0):
    return invoke("take", (a, indices), {"axis": axis})


def einsum(subscripts, *operands):
    return NDArray(torch.einsum(subscripts, *[_unwrap_tree(o)
                                              for o in operands]))


def asarray(a, dtype=None):
    return array(a, dtype=dtype)


def asanyarray(a, dtype=None):
    return asarray(a, dtype=dtype)


def ascontiguousarray(a, dtype=None):
    out = asarray(a, dtype=dtype)
    return NDArray(out._data.contiguous())


def asfortranarray(a, dtype=None):
    return asarray(a, dtype=dtype)  # torch keeps no Fortran order


def asarray_chkfinite(a, dtype=None):
    out = asarray(a, dtype=dtype)
    if not bool(torch.isfinite(out._data).all()):
        raise ValueError("array must not contain infs or NaNs")
    return out


def in1d(ar1, ar2, **kwargs):
    a = _t(ar1)
    return NDArray(torch.isin(a.reshape(-1), _t(ar2).to(a.device), **kwargs))


def asnumpy(a):
    return a.asnumpy() if isinstance(a, NDArray) else _onp.asarray(a)


def zeros_like(a):
    return invoke("zeros_like", (a,), {})


def ones_like(a):
    return invoke("ones_like", (a,), {})


# ---------------------------------------------------------------------------
# the rest of numpy's names, resolved on first use
# ---------------------------------------------------------------------------

import types as _types  # noqa: E402

# numpy names whose torch function of the same name takes numpy's
# positional arguments and gives numpy's results (``axis``/``keepdims``
# renamed, a ``dtype`` translated): they run on the arrays' device
TORCH_NAMES = frozenset((
    "absolute", "all", "allclose", "any", "arccosh", "arcsinh", "arctanh",
    "argwhere", "bitwise_and", "bitwise_not", "bitwise_or", "bitwise_xor",
    "copysign", "cos", "cosh", "count_nonzero", "deg2rad", "diag", "diff",
    "exp2", "float_power", "floor_divide", "fmax", "fmin", "fmod",
    "heaviside", "i0", "inner", "isclose", "isfinite", "isinf", "isnan",
    "isneginf", "isposinf", "kron", "lcm", "gcd", "ldexp", "logaddexp",
    "logaddexp2", "logical_not", "nan_to_num", "nextafter", "outer",
    "rad2deg", "remainder", "rot90", "sinc", "signbit", "trace", "tril",
    "triu", "trunc", "vander", "nansum", "ravel", "moveaxis",
    "atleast_1d", "atleast_2d", "atleast_3d", "hstack", "vstack", "dstack",
    "column_stack", "searchsorted", "bincount", "positive", "conj", "real",
    "angle", "fliplr", "flipud", "acos", "acosh", "asin", "asinh", "atan",
    "atan2", "atanh", "bitwise_left_shift", "bitwise_right_shift",
    "broadcast_shapes", "concat", "corrcoef", "diagflat", "diagonal",
    "dsplit", "hsplit", "vsplit", "empty_like", "fix", "frexp",
    "full_like", "imag", "isin", "isreal", "nanmean", "nanquantile",
    "quantile", "row_stack", "tensordot", "trapezoid", "trapz",
    "unravel_index",
))
# numpy names that are a torch function of another name
TORCH_ALIASES = {
    "conjugate": "conj", "degrees": "rad2deg", "radians": "deg2rad",
    "fabs": "abs", "invert": "bitwise_not", "left_shift":
    "bitwise_left_shift", "right_shift": "bitwise_right_shift",
    "broadcast_arrays": "broadcast_tensors", "array_split": "tensor_split",
}
# numpy names of a host nature (printing, files, error state, dtype and
# shape queries, numpy's own submodules and classes): numpy's own object,
# as the JAX package gives its ``_ONP_HOST_NAMES`` (the host functions it
# wraps, ``_host_fn`` below wraps here)
HOST_NAMES = frozenset((
    "ScalarType", "asmatrix", "bmat", "broadcast", "busday_count",
    "busday_offset", "busdaycalendar", "char", "clongdouble", "complex256",
    "core", "ctypeslib", "datetime_as_string", "datetime_data", "dtypes",
    "emath", "exceptions", "f2py", "flatiter", "float128", "fromregex",
    "get_include", "getbufsize", "geterrcall", "info", "is_busday",
    "isfortran", "isnat", "lib", "ma", "matrix", "may_share_memory",
    "memmap", "nditer", "nested_iters", "poly1d", "polynomial", "putmask",
    "rec", "recarray", "record", "require", "sctypeDict", "setbufsize",
    "seterrcall", "shares_memory", "show_config", "show_runtime", "strings",
    "testing", "typecodes", "typing",
    "ndim", "shape", "size", "isscalar", "iterable", "can_cast",
    "promote_types", "result_type", "issubdtype", "isdtype",
    "set_printoptions",
    "get_printoptions", "printoptions", "seterr", "geterr",
))
_KW = {"axis": "dim", "keepdims": "keepdim", "axes": "dims",
       "axis1": "dim1", "axis2": "dim2"}


def _unwrap_tree(v):
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, (list, tuple)):
        return type(v)(_unwrap_tree(x) for x in v)
    return v


def _wrap_tree(v):
    """Tensors as NDArrays, through tuples and lists."""
    if isinstance(v, torch.Tensor):
        return NDArray(v)
    if isinstance(v, tuple):
        return tuple(_wrap_tree(x) for x in v)
    if isinstance(v, list):
        return [_wrap_tree(x) for x in v]
    return v


def _torch_fn(fn, name):
    from .base import resolve_dtype

    def g(*args, **kwargs):
        args = [_unwrap_tree(a) for a in args]
        kwargs = {_KW.get(k, k): _unwrap_tree(v) for k, v in kwargs.items()}
        if kwargs.get("dtype") is not None:
            kwargs["dtype"] = resolve_dtype(kwargs["dtype"])
        return _wrap_tree(fn(*args, **kwargs))

    g.__name__ = g.__qualname__ = name
    g.__doc__ = "mx.np.%s: torch.%s on the arrays' device." % (
        name, fn.__name__)
    return g


class _DelegatedModule(_types.ModuleType):
    """A torch submodule (``linalg``, ``fft``) with NDArray in and out."""

    def __init__(self, base, name):
        super().__init__(name)
        self._base = base

    def __getattr__(self, name):
        fn = getattr(self._base, name)
        if not callable(fn):
            return fn
        g = _torch_fn(fn, name)
        setattr(self, name, g)
        return g


linalg = _DelegatedModule(torch.linalg, "mxnet_tpu_torch.np.linalg")
fft = _DelegatedModule(torch.fft, "mxnet_tpu_torch.np.fft")


def __getattr__(name):
    import sys

    if name in TORCH_NAMES or name in TORCH_ALIASES:
        g = _torch_fn(getattr(torch, TORCH_ALIASES.get(name, name)), name)
    elif name in HOST_NAMES and hasattr(_onp, name):
        g = getattr(_onp, name)
    else:
        v = getattr(_onp, name, None)
        if v is None or callable(v) and not isinstance(v, type):
            raise AttributeError(
                "mx.np has no attribute %r: not a wrapper here, not in "
                "TORCH_NAMES or TORCH_ALIASES (torch on the arrays' device) "
                "and not in HOST_NAMES (numpy's own)" % name)
        return v  # dtypes, constants, numpy's classes
    setattr(sys.modules[__name__], name, g)
    return g


# ---------------------------------------------------------------------------
# numpy's semantics on torch where torch's function of the name has
# another default or result, or there is none
# ---------------------------------------------------------------------------

def _t(a):
    return a._data if isinstance(a, NDArray) else asarray(a)._data


def _all_dims(x, axis):
    return tuple(range(x.dim())) if axis is None else axis


def _float(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _quantile(fn, a, q, axis, keepdims, scale=1.0):
    x = _float(_t(a))
    q = torch.as_tensor(_unwrap_tree(q), dtype=x.dtype, device=x.device)
    return NDArray(fn(x, q / scale, dim=axis, keepdim=keepdims))


def median(a, axis=None, keepdims=False):
    """The mean of the two middle values for an even count, as numpy's
    (``torch.median`` takes the lower one)."""
    return _quantile(torch.quantile, a, 0.5, axis, keepdims)


def nanmedian(a, axis=None, keepdims=False):
    return _quantile(torch.nanquantile, a, 0.5, axis, keepdims)


def percentile(a, q, axis=None, keepdims=False):
    return _quantile(torch.quantile, a, q, axis, keepdims, 100.0)


def nanpercentile(a, q, axis=None, keepdims=False):
    return _quantile(torch.nanquantile, a, q, axis, keepdims, 100.0)


def average(a, axis=None, weights=None, returned=False, keepdims=False):
    x = _float(_t(a))
    dims = _all_dims(x, axis)
    if weights is None:
        avg = x.mean(dim=dims, keepdim=keepdims)
        scl = torch.full_like(avg, x.numel() // _onp.prod(avg.shape,
                                                          dtype=int))
    else:
        w = _t(weights).to(x.dtype)
        if w.shape != x.shape:  # 1-D weights along ``axis``
            shape = [1] * x.dim()
            shape[axis] = -1
            w = w.reshape(shape)
        scl = torch.broadcast_to(w, x.shape).sum(dim=dims, keepdim=keepdims)
        avg = (x * w).sum(dim=dims, keepdim=keepdims) / scl
    return (NDArray(avg), NDArray(scl)) if returned else NDArray(avg)


def cumprod(a, axis=None):
    x = _t(a)
    return NDArray(torch.cumprod(x.reshape(-1) if axis is None else x,
                                 0 if axis is None else axis))


def unique(ar, return_index=False, return_inverse=False,
           return_counts=False, axis=None):
    x = _t(ar)
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    out = [NDArray(vals)]
    if return_index:
        n = x.numel() if axis is None else x.shape[axis]
        first = torch.full((counts.numel(),), n, dtype=torch.long,
                           device=x.device).scatter_reduce(
            0, inv.reshape(-1), torch.arange(n, device=x.device), "amin")
        out.append(NDArray(first))
    if return_inverse:
        out.append(NDArray(inv))
    if return_counts:
        out.append(NDArray(counts))
    return out[0] if len(out) == 1 else tuple(out)


def _pad_part(x, ax, w, end, mode, fill):
    """The ``w`` entries that ``pad`` puts before (or, with ``end``,
    after) ``x`` along ``ax``."""
    n = x.shape[ax]
    if w == 0:
        return x.narrow(ax, 0, 0)
    if mode == "constant":
        shape = list(x.shape)
        shape[ax] = w
        return x.new_full(shape, fill)
    if mode == "edge":
        return x.narrow(ax, n - 1 if end else 0, 1).repeat_interleave(
            w, dim=ax)
    if mode not in ("reflect", "symmetric", "wrap"):
        raise ValueError("mx.np.pad: mode %r is not supported" % (mode,))
    off = 1 if mode == "reflect" else 0
    if w + off > n:
        raise ValueError("mx.np.pad mode %r: a width of %d along axis %d of "
                         "length %d" % (mode, w, ax, n))
    if mode == "wrap":
        return x.narrow(ax, 0 if end else n - w, w)
    return x.narrow(ax, n - off - w if end else off, w).flip(ax)


def pad(array, pad_width, mode="constant", constant_values=0):
    """numpy's ``constant``, ``edge``, ``reflect``, ``symmetric`` and
    ``wrap`` modes, axis by axis into the padded array, as numpy fills
    it; the last three need each width below the axis's length."""
    x = _t(array)
    widths = _onp.broadcast_to(_onp.asarray(pad_width, _onp.int64),
                               (x.dim(), 2)).tolist()
    fills = _onp.broadcast_to(_onp.asarray(constant_values),
                              (x.dim(), 2)).tolist()
    out = x.new_empty([n + lo + hi for n, (lo, hi) in zip(x.shape, widths)])
    inner = out
    for ax, (lo, _) in enumerate(widths):
        inner = inner.narrow(ax, lo, x.shape[ax])
    inner.copy_(x)
    for ax, ((lo, hi), (f_lo, f_hi)) in enumerate(zip(widths, fills)):
        core = out.narrow(ax, lo, x.shape[ax])
        out.narrow(ax, 0, lo).copy_(_pad_part(core, ax, lo, False, mode,
                                              f_lo))
        out.narrow(ax, lo + x.shape[ax], hi).copy_(
            _pad_part(core, ax, hi, True, mode, f_hi))
    return NDArray(out)


def append(arr, values, axis=None):
    a = _t(arr)
    v = _t(values).to(a.device)
    if axis is None:
        return NDArray(torch.cat([a.reshape(-1), v.reshape(-1)]))
    return NDArray(torch.cat([a, v], dim=axis))


def roll(a, shift, axis=None):
    return NDArray(torch.roll(_t(a), shift, dims=axis))


def around(a, decimals=0):
    x = _t(a)
    if not x.is_floating_point() and decimals >= 0:
        return NDArray(x.clone())
    return NDArray(torch.round(x, decimals=decimals))


round = around


def rint(a):
    return around(a)


def vdot(a, b):
    return NDArray(torch.vdot(_t(a).reshape(-1), _t(b).reshape(-1)))


def cross(a, b, axis=-1):
    return NDArray(torch.linalg.cross(_t(a), _t(b), dim=axis))


def meshgrid(*xi, indexing="xy"):
    return tuple(NDArray(t) for t in torch.meshgrid(
        *[_t(x) for x in xi], indexing=indexing))


def nonzero(a):
    return tuple(NDArray(t) for t in torch.nonzero(_t(a), as_tuple=True))


def copy(a):
    return NDArray(_t(a).clone())


def identity(n, dtype=None):
    return eye(n, dtype=dtype)


def ptp(a, axis=None, keepdims=False):
    x = _t(a)
    dims = _all_dims(x, axis)
    return NDArray(x.amax(dims, keepdims) - x.amin(dims, keepdims))


def take_along_axis(arr, indices, axis):
    return NDArray(torch.take_along_dim(_t(arr), _t(indices).long(),
                                        dim=axis))


def array_equal(a1, a2):
    x, y = _t(a1), _t(a2)
    return x.shape == y.shape and torch.equal(x, y.to(x.device, x.dtype))


def matrix_transpose(x):
    return NDArray(_t(x).transpose(-1, -2))


permute_dims = transpose


def _host_fn(name):
    """numpy's ``name`` on the host for what is host work by nature
    (files, text, dtype queries): NDArray arguments as numpy arrays."""
    fn = getattr(_onp, name)

    def g(*args, **kwargs):
        return fn(*[a.asnumpy() if isinstance(a, NDArray) else a
                    for a in args], **kwargs)

    g.__name__ = g.__qualname__ = name
    return g


loadtxt = _host_fn("loadtxt")
genfromtxt = _host_fn("genfromtxt")
savetxt = _host_fn("savetxt")
savez_compressed = _host_fn("savez_compressed")
array2string = _host_fn("array2string")
format_float_positional = _host_fn("format_float_positional")
format_float_scientific = _host_fn("format_float_scientific")
base_repr = _host_fn("base_repr")
binary_repr = _host_fn("binary_repr")
typename = _host_fn("typename")
min_scalar_type = _host_fn("min_scalar_type")
common_type = _host_fn("common_type")
mintypecode = _host_fn("mintypecode")
real_if_close = _host_fn("real_if_close")
save = _host_fn("save")
savez = _host_fn("savez")


def load(file, *args, **kwargs):
    """numpy's ``load``; an array read comes back as an NDArray."""
    out = _onp.load(file, *args, **kwargs)
    return asarray(out, dtype=out.dtype) if isinstance(
        out, _onp.ndarray) else out


def copyto(dst, src):
    dst._rebind(asarray(src)._data.to(dst._data.device, dst._data.dtype))
