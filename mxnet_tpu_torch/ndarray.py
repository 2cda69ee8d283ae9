"""NDArray: MXNet's imperative array over one torch tensor (ref:
python/mxnet/ndarray/ndarray.py; the JAX package's ``mxnet_tpu/ndarray.py``).

An ``NDArray`` holds one ``torch.Tensor`` in ``_data``, as the JAX class
holds a ``jax.Array``. It is not a tensor subclass: MXNet's ``size`` is an
int, ``reshape`` takes the codes 0/-1/-2/-3/-4, ``sum`` takes ``axis=``
and ``grad`` is a property, none of which a tensor can be.

Every op goes through :func:`invoke`: unwrap, call the registry function
(``ops``), wrap. Inside ``autograd.record()`` it runs with torch's grad mode
on, and a floating-point input that is not yet part of a graph becomes a
leaf that requires grad, so ``autograd.grad`` may ask for the gradient of
any array read while recording (the JAX package records every inexact
input). Outside ``record()`` no graph is built.

Mutation (``x[...] = v``, ``x += 1``) rebinds ``_data`` to a new tensor,
as the JAX package rebinds its buffer: a slice taken before the write keeps
its old values, and a recorded graph keeps the tensor it read. The one
exception is an NDArray that ``Parameter.data()`` returned: a write to it
goes into the parameter's live tensor, as in MXNet.

The bulk window (``engine.bulk``, ``MXNET_ENGINE_BULK_SIZE``, off by
default: ``ROADMAP.md`` C.2; the JAX package's ``LazyExpr``): outside ``autograd.record()``, a fusible op (a
single-output elementwise, broadcast, shape or reduction op of
:data:`FUSIBLE`, with arrays and python scalars as operands and static
keyword arguments) does not run: it returns an array whose value is a node
of the current thread's window, whose shape and dtype come from the op run
on ``meta`` tensors (so ``shape``/``dtype`` do not flush). The window runs
as one program at a sync point: reading the value (``_data``, and so
``asnumpy``, a scalar read, a non-fusible consumer), mutation, entering
``autograd.record()``, the watermark, ``waitall``. The program is cached by
the chain's structure and its leaves' signatures; a python scalar is a
leaf, not part of the key, so a changed scalar builds nothing. On a CUDA
device a window of two or more nodes is one CUDA graph (``capture.py``):
its leaves are copied into the graph's inputs, the graph replays the
chain's kernels as one launch, and its outputs are copied out; a scalar is
a 0-d tensor there. On the CPU the same window runs its nodes eagerly, with
the same keys and counts. A node holds the tensors its inputs had when it
was issued, so rebinding an input array later does not reach it; a tensor
written in place before the flush raises there.

A bfloat16 array's ``asnumpy()`` returns float32 values, which hold every
bfloat16 exactly (numpy has no bfloat16 without ``ml_dtypes``).
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from . import autograd
from . import engine as _engine
from . import profiler as _profiler
from .base import OP_REGISTRY, register_op, resolve_device, resolve_dtype
from .context import Context, context_from_device, current_context
from .ops.functional import basic_index

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "linspace", "eye", "concat", "stack", "waitall", "invoke", "save",
           "load"]

# numpy has no bfloat16 or fp8: those dtypes report their name
_NUMPY_DTYPES = {
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64, torch.int8: np.int8, torch.uint8: np.uint8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.bool: np.bool_,
}


class DTypeName(str):
    """The dtype of a bfloat16 or fp8 array: its name, comparable with a
    string and taken by ``resolve_dtype``."""

    @property
    def name(self):
        return str(self)


def np_dtype(tdt):
    """A torch dtype as the JAX package reports it: a numpy dtype, or the
    name of one numpy lacks."""
    nd = _NUMPY_DTYPES.get(tdt)
    if nd is not None:
        return np.dtype(nd)
    return DTypeName(str(tdt).replace("torch.", ""))


class NDArray:
    __slots__ = ("_buf", "_lazy", "_grad", "_grad_req", "_param",
                 "__weakref__")

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(data)
        if ctx is not None:
            data = data.to(resolve_device(Context(ctx)))
        self._buf = data
        self._lazy = None
        self._grad = None
        self._grad_req = "write"
        self._param = None

    @property
    def _data(self):
        """The value as a tensor; a deferred value flushes its window."""
        if self._lazy is not None:
            _engine.flush()
            if self._lazy is not None:
                raise RuntimeError("an array deferred on another thread's "
                                   "bulk window was read")
        return self._buf

    @_data.setter
    def _data(self, tensor):
        self._buf = tensor
        self._lazy = None

    def _meta(self):
        """A tensor with this array's shape and dtype: the value, or a
        deferred node's ``meta`` tensor (no flush)."""
        lz = self._lazy
        return lz.meta if lz is not None else self._buf

    # ------------------------------------------------------------ properties
    @property
    def shape(self):
        return tuple(self._meta().shape)

    @property
    def dtype(self):
        return np_dtype(self._meta().dtype)

    @property
    def size(self):
        return int(self._meta().numel())

    @property
    def ndim(self):
        return self._meta().dim()

    @property
    def context(self):
        lz = self._lazy
        return context_from_device(lz.device if lz is not None
                                   else self._buf.device)

    ctx = context

    @property
    def T(self):
        return self.transpose()

    @property
    def grad(self):
        return self._grad

    @property
    def grad_req(self):
        return self._grad_req

    # ------------------------------------------------------------ data access
    def asnumpy(self):
        """A numpy copy of the values (bfloat16 and fp8 as float32)."""
        t = self._data.detach()
        if t.dtype not in _NUMPY_DTYPES:
            t = t.to(torch.float32)
        return np.array(t.cpu().numpy(), copy=True)

    def asscalar(self):
        return self.asnumpy().item()

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self.asnumpy().all())

    def __len__(self):
        return self.shape[0]

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    def wait_to_read(self):
        """Wait for the work that writes this array: its device's current
        stream, on which every op of the port runs."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    # ------------------------------------------------------------ conversion
    def astype(self, dtype, copy=True):
        return invoke("cast", (self,), {"dtype": dtype})

    def copy(self):
        return NDArray(self._data.detach().clone())

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._rebind(self._data.detach().to(other._data.device,
                                                 copy=True))
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(
                resolve_device(other), copy=True))
        raise TypeError("copyto target must be NDArray or Context")

    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        return NDArray(self._data.detach(), ctx=ctx)

    as_in_ctx = as_in_context

    def detach(self):
        return NDArray(self._data.detach())

    # ------------------------------------------------------------ autograd
    def attach_grad(self, grad_req="write"):
        """Give this array a gradient buffer of zeros, written by
        ``backward`` under ``grad_req`` (``write``, ``add`` or ``null``).
        An array with no recorded history becomes a leaf of the next
        recorded graph; one computed inside ``record()`` keeps its history,
        and its gradient is the one at its own site."""
        if grad_req not in ("write", "add", "null"):
            raise ValueError("grad_req must be write, add or null, got %r"
                             % (grad_req,))
        t = self._data
        if t.grad_fn is None and (t.is_floating_point() or t.is_complex()):
            self._data = t.detach().requires_grad_(True)
        self._grad = NDArray(torch.zeros_like(t.detach()))
        self._grad_req = grad_req

    def _store_grad(self, g):
        """Store a gradient from ``autograd.backward`` by ``grad_req``."""
        if self._grad_req == "null" or self._grad is None:
            return
        g = g.detach()
        if self._grad_req == "add":
            g = self._grad._data + g
        self._grad._data = g

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    # ------------------------------------------------------------ mutation
    def _rebind(self, tensor):
        """Make ``tensor`` this array's value. An array that wraps a
        parameter's live tensor writes into it in place instead."""
        _engine.flush()  # a deferred op may read the tensor written here
        p = self._param
        if p is not None and p._data is self._data:
            with torch.no_grad():
                self._data.copy_(tensor)
            return
        self._data = tensor

    def __getitem__(self, key):
        return _getitem(self, key)

    def __setitem__(self, key, value):
        _engine.flush()
        k = _normalize_key(key)
        v = value._data if isinstance(value, NDArray) else value
        p = self._param
        if p is not None and p._data is self._data:
            with torch.no_grad():
                _set_index(self._data, k, v)
            return
        with torch.set_grad_enabled(autograd.is_recording()):
            new = self._data.clone()
            _set_index(new, k, v)
        self._data = new

    # ------------------------------------------------------------ arithmetic
    def __add__(self, o):
        return invoke("add", (self, o), {})

    __radd__ = __add__

    def __sub__(self, o):
        return invoke("subtract", (self, o), {})

    def __rsub__(self, o):
        return invoke("subtract", (o, self), {})

    def __mul__(self, o):
        return invoke("multiply", (self, o), {})

    __rmul__ = __mul__

    def __truediv__(self, o):
        return invoke("divide", (self, o), {})

    def __rtruediv__(self, o):
        return invoke("divide", (o, self), {})

    def __mod__(self, o):
        return invoke("mod", (self, o), {})

    def __rmod__(self, o):
        return invoke("mod", (o, self), {})

    def __pow__(self, o):
        return invoke("power", (self, o), {})

    def __rpow__(self, o):
        return invoke("power", (o, self), {})

    def __neg__(self):
        return invoke("negative", (self,), {})

    def __abs__(self):
        return invoke("abs", (self,), {})

    def __matmul__(self, o):
        return invoke("matmul", (self, o), {})

    def __iadd__(self, o):
        self._rebind((self + o)._data)
        return self

    def __isub__(self, o):
        self._rebind((self - o)._data)
        return self

    def __imul__(self, o):
        self._rebind((self * o)._data)
        return self

    def __itruediv__(self, o):
        self._rebind((self / o)._data)
        return self

    def __eq__(self, o):
        return invoke("equal", (self, o), {})

    def __ne__(self, o):
        return invoke("not_equal", (self, o), {})

    def __gt__(self, o):
        return invoke("greater", (self, o), {})

    def __ge__(self, o):
        return invoke("greater_equal", (self, o), {})

    def __lt__(self, o):
        return invoke("lesser", (self, o), {})

    def __le__(self, o):
        return invoke("lesser_equal", (self, o), {})

    __hash__ = object.__hash__

    # ------------------------------------------------------------ methods
    def reshape(self, *shape, **kwargs):
        if "shape" in kwargs:
            shape = kwargs["shape"]
        elif len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return invoke("reshape", (self,), {"shape": tuple(shape)})

    def flatten(self):
        return invoke("flatten", (self,), {})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return invoke("transpose", (self,), {"axes": axes or None})

    def swapaxes(self, dim1, dim2):
        return invoke("swapaxes", (self,), {"dim1": dim1, "dim2": dim2})

    def expand_dims(self, axis):
        return invoke("expand_dims", (self,), {"axis": axis})

    def squeeze(self, axis=None):
        return invoke("squeeze", (self,), {"axis": axis})

    def broadcast_to(self, shape):
        return invoke("broadcast_to", (self,), {"shape": tuple(shape)})

    def sum(self, axis=None, keepdims=False):
        return invoke("sum", (self,), {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return invoke("mean", (self,), {"axis": axis, "keepdims": keepdims})

    def max(self, axis=None, keepdims=False):
        return invoke("max", (self,), {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False):
        return invoke("min", (self,), {"axis": axis, "keepdims": keepdims})

    def prod(self, axis=None, keepdims=False):
        return invoke("prod", (self,), {"axis": axis, "keepdims": keepdims})

    def argmax(self, axis=None):
        return invoke("argmax", (self,), {"axis": axis})

    def argmin(self, axis=None):
        return invoke("argmin", (self,), {"axis": axis})

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke("norm", (self,), {"ord": ord, "axis": axis,
                                        "keepdims": keepdims})

    def abs(self):
        return invoke("abs", (self,), {})

    def sqrt(self):
        return invoke("sqrt", (self,), {})

    def exp(self):
        return invoke("exp", (self,), {})

    def log(self):
        return invoke("log", (self,), {})

    def clip(self, a_min, a_max):
        return invoke("clip", (self,), {"a_min": a_min, "a_max": a_max})

    def sigmoid(self):
        return invoke("sigmoid", (self,), {})

    def tanh(self):
        return invoke("tanh", (self,), {})

    def relu(self):
        return invoke("relu", (self,), {})

    def softmax(self, axis=-1):
        return invoke("softmax", (self,), {"axis": axis})

    def one_hot(self, depth, **kw):
        return invoke("one_hot", (self,), {"depth": depth, **kw})

    def take(self, indices, axis=0):
        return invoke("take", (self, indices), {"axis": axis})

    def tile(self, reps):
        return invoke("tile", (self,), {"reps": reps})

    def repeat(self, repeats, axis=None):
        return invoke("repeat", (self,), {"repeats": repeats, "axis": axis})

    def slice_axis(self, axis, begin, end):
        return invoke("slice_axis", (self,), {"axis": axis, "begin": begin,
                                              "end": end})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke("split", (self,), {"num_outputs": num_outputs,
                                         "axis": axis,
                                         "squeeze_axis": squeeze_axis})

    def zeros_like(self):
        return invoke("zeros_like", (self,), {})

    def ones_like(self):
        return invoke("ones_like", (self,), {})

    def tostype(self, stype):
        return self  # dense only; sparse storage is ROADMAP.md A.17

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            np.array2string(self.asnumpy(), threshold=20),
            "x".join(str(s) for s in self.shape), self.context)


# ---------------------------------------------------------------- dispatch


def unwrap(x, recording):
    """The tensor of ``x`` (an NDArray; anything else passes through) for
    an op. While recording, a floating-point array outside any graph
    becomes a leaf that requires grad, and an array with a gradient
    buffer is registered for ``autograd.backward``."""
    if not isinstance(x, NDArray):
        return x
    t = x._data
    if recording:
        if not t.requires_grad and (t.is_floating_point()
                                    or t.is_complex()):
            t = x._data = t.detach().requires_grad_(True)
        if x._grad is not None:
            autograd.read_variable(x, t)
    return t


def wrap(out):
    """Tensors → NDArrays, through tuples and lists."""
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, tuple):
        return tuple(wrap(o) for o in out)
    if isinstance(out, list):
        return [wrap(o) for o in out]
    return out


# per-op dispatch counts (observability.enable_op_telemetry): off, the hot
# loop reads one module boolean
_obs_on = False
_obs_counts = {}


def invoke(opname, args, kwargs):
    """Run registry op ``opname`` on NDArrays: defer it into the bulk
    window when it is fusible there (module docstring), else unwrap the
    arguments, call it with torch's grad mode set from
    ``autograd.is_recording()`` (off for a ``nondiff`` op), wrap the
    result. ``out=`` rebinds that array to the (first) result and returns
    it; an op that reads the training flag gets ``autograd.is_training()``
    unless the caller passed ``training``."""
    fn = OP_REGISTRY[opname]
    if _engine._bulk_size > 0 and opname in FUSIBLE \
            and not autograd.is_recording():
        out = _defer(opname, fn, args, kwargs)
        if out is not None:
            return out
    _engine.dispatch_counter.count += 1
    if _obs_on:
        _obs_counts[opname] = _obs_counts.get(opname, 0) + 1
    kwargs = dict(kwargs)
    out = kwargs.pop("out", None)
    if getattr(fn, "needs_training", False) and "training" not in kwargs:
        kwargs["training"] = autograd.is_training()
    rec = autograd.is_recording()
    targs = [unwrap(a, rec) for a in args]
    tkw = {k: unwrap(v, rec) for k, v in kwargs.items()}
    with torch.set_grad_enabled(rec and not getattr(fn, "nondiff", False)):
        raw = fn(*targs, **tkw)
    if rec:
        autograd._record_entry(fn, targs, tkw, raw)
    res = wrap(raw)
    if out is not None:
        src = res if isinstance(res, NDArray) else res[0]
        out._rebind(src._data)
        return out
    return res


# ---------------------------------------------------------------- bulk window

# the ops the window defers: single output, no random draw or training
# flag, no host read of a value, so a chain of them is one CUDA graph
FUSIBLE = frozenset((
    "abs", "sign", "ceil", "floor", "trunc", "round", "rint", "fix", "exp",
    "expm1", "log", "log1p", "log2", "log10", "sqrt", "rsqrt", "cbrt",
    "rcbrt", "square", "reciprocal", "negative", "sin", "cos", "tan",
    "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
    "arccosh", "arctanh", "degrees", "radians", "erf", "erfinv", "gammaln",
    "digamma", "softsign", "relu", "softrelu", "logical_not", "isnan",
    "isinf", "isfinite", "sigmoid", "relu6", "clip",
    "add", "subtract", "multiply", "divide", "mod", "power", "maximum",
    "minimum", "hypot", "arctan2", "equal", "not_equal", "greater",
    "greater_equal", "lesser", "lesser_equal", "logical_and", "logical_or",
    "logical_xor", "broadcast_add", "broadcast_sub", "broadcast_mul",
    "broadcast_div", "broadcast_mod", "broadcast_power",
    "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
    "broadcast_equal", "broadcast_not_equal", "broadcast_greater",
    "broadcast_greater_equal", "broadcast_lesser", "broadcast_lesser_equal",
    "broadcast_logical_and", "broadcast_logical_or",
    "broadcast_logical_xor", "where", "cast", "reshape", "transpose",
    "expand_dims", "squeeze", "flatten", "swapaxes", "broadcast_to",
    "broadcast_like", "sum", "mean", "max", "min", "prod", "softmax",
    "log_softmax", "zeros_like", "ones_like", "dot", "matmul", "batch_dot"))
# ops whose result dtype follows their first operand: a python scalar
# there is not the same as a 0-d tensor, so such a call runs eagerly
_FIRST_OPERAND_DTYPE = frozenset((
    "equal", "not_equal", "greater", "greater_equal", "lesser",
    "lesser_equal", "broadcast_equal", "broadcast_not_equal",
    "broadcast_greater", "broadcast_greater_equal", "broadcast_lesser",
    "broadcast_lesser_equal"))
_SCALARS = (bool, int, float)
_STATIC = (type(None), bool, int, float, str, tuple, list, torch.dtype,
           np.dtype, type)
# (op, static attrs, input signatures) -> the output's meta tensor, or None
# when the op does not run on meta tensors (it then runs eagerly)
_META = {}
_META_CAP = 4096
# window programs by key, least recently used first
_PROGRAMS = {}
PROGRAM_CAP = 64


class _Node:
    """One deferred op: its function, static attrs and wiring (``specs``:
    ``i >= 0`` is node i's result, ``~li`` leaf li), its output's meta
    tensor, and a weak reference to its output array."""

    __slots__ = ("op", "fn", "kwargs", "specs", "meta", "device", "ref",
                 "idx")


def _freeze(v):
    if isinstance(v, (list, tuple)):
        return (type(v).__name__,) + tuple(_freeze(x) for x in v)
    if isinstance(v, (torch.dtype, np.dtype, type)):
        return ("dtype", str(v))
    return (type(v).__name__, v)


def _tensor_sig(t):
    return (tuple(t.shape), t.dtype, tuple(t.stride()))


def _defer(opname, fn, args, kwargs):
    """The output array of ``opname`` deferred into this thread's window,
    or None when the call cannot be deferred (it then runs eagerly)."""
    if "out" in kwargs or any(not isinstance(v, _STATIC)
                              for v in kwargs.values()):
        return None
    w = _engine._window()
    device = w.device
    plan = []
    for a in args:
        if isinstance(a, NDArray):
            lz = a._lazy
            if lz is not None:
                if lz.idx >= len(w.nodes) or w.nodes[lz.idx] is not lz:
                    return None  # another thread's window
                dev = lz.device
            else:
                dev = a._buf.device
                if dev.type not in ("cpu", "cuda"):
                    return None
            if device is None:
                device = dev
            elif dev != device:
                return None
            plan.append(a)
        elif type(a) in _SCALARS:
            plan.append(a)
        else:
            return None
    if not plan or device is None or (
            opname in _FIRST_OPERAND_DTYPE and not isinstance(args[0],
                                                              NDArray)):
        return None
    skey = tuple(sorted((k, _freeze(v)) for k, v in kwargs.items()))
    metas, msigs = [], []
    for a in plan:
        if isinstance(a, NDArray):
            m = a._lazy.meta if a._lazy is not None else a._buf
            metas.append(m if a._lazy is not None else torch.empty_strided(
                m.shape, m.stride(), dtype=m.dtype, device="meta"))
            msigs.append(_tensor_sig(m))
        else:
            metas.append(a)
            msigs.append(type(a))
    mkey = (opname, skey, tuple(msigs))
    meta = _META.get(mkey, _META)
    if meta is _META:
        try:
            with torch.no_grad():
                meta = fn(*metas, **kwargs)
            if not isinstance(meta, torch.Tensor):
                meta = None
        except Exception:  # the op does not run on meta: run it eagerly
            meta = None
        if len(_META) >= _META_CAP:
            _META.clear()
        _META[mkey] = meta
    if meta is None:
        return None
    w.device = device
    specs = []
    for a in plan:
        if isinstance(a, NDArray) and a._lazy is not None:
            specs.append(a._lazy.idx)
            continue
        if isinstance(a, NDArray):
            t = a._buf
            lkey = id(t)
            sig = _tensor_sig(t) + (str(t.device),)
        else:
            t = a
            lkey = (type(a), a)
            sig = type(a)
        li = w.leaf_ids.get(lkey)
        if li is None:
            li = w.leaf_ids[lkey] = len(w.leaves)
            w.leaves.append(t)
            w.leaf_sigs.append(sig)
            if isinstance(t, torch.Tensor):
                w.versions[li] = t._version
        specs.append(~li)
    node = _Node()
    node.op, node.fn, node.kwargs = opname, fn, dict(kwargs)
    node.specs, node.meta, node.device = tuple(specs), meta, device
    node.idx = len(w.nodes)
    out = NDArray.__new__(NDArray)
    out._buf = None
    out._lazy = node
    out._grad = None
    out._grad_req = "write"
    out._param = None
    node.ref = weakref.ref(out)
    w.nodes.append(node)
    w.key_parts.append((opname, skey, node.specs))
    if len(w.nodes) >= _engine._bulk_size:  # the watermark
        _flush_window()
    return out


def _run_chain(structure, leaves, want):
    """The chain's nodes run in order on ``leaves``; the results at
    ``want``."""
    vals = []
    with torch.no_grad():
        for fn, kwargs, specs in structure:
            vals.append(fn(*[vals[i] if i >= 0 else leaves[~i]
                             for i in specs], **kwargs))
    return [vals[i] for i in want]


_pools = {}


class _WindowProgram:
    """A chain captured as one CUDA graph over static leaves (a python
    scalar is a 0-d tensor there, which the registry ops treat as they
    treat the scalar). Every window program of a device shares one memory
    pool: a replay's outputs are copied out before any other replays."""

    def __init__(self, structure, leaves, want, device):
        from .capture import capture_graph

        self.static = []
        with torch.no_grad():
            for leaf in leaves:
                if isinstance(leaf, torch.Tensor):
                    s = torch.empty_like(leaf)
                    s.copy_(leaf)
                else:
                    s = torch.tensor(leaf, device=device)
                self.static.append(s)
        if device.index not in _pools:
            _pools[device.index] = torch.cuda.graph_pool_handle()
        self.graph = capture_graph(
            lambda: _run_chain(structure, self.static, want), device,
            _pools[device.index])

    def __call__(self, leaves):
        with torch.no_grad():
            for s, leaf in zip(self.static, leaves):
                if isinstance(leaf, torch.Tensor):
                    s.copy_(leaf)
                else:
                    s.fill_(leaf)
            return [o.clone() for o in self.graph.replay()]


def _flush_window():
    """Run the current thread's window as one program and bind the results
    to the output arrays still alive (engine module docstring)."""
    w = _engine._window()
    nodes = w.nodes
    if not nodes:
        return
    leaves, device = w.leaves, w.device
    outs = []
    for node in nodes:
        arr = node.ref()
        if arr is not None and arr._lazy is node:
            outs.append((node.idx, arr))
    key = (tuple(w.key_parts), tuple(w.leaf_sigs),
           tuple(i for i, _ in outs))
    versions = w.versions
    w.reset()  # first: nothing below may reach the same window
    for li, ver in versions.items():
        if leaves[li]._version != ver:
            raise RuntimeError(
                "a tensor read by a deferred %s op was written in place "
                "before the bulk window flushed; flush first "
                "(engine.flush())" % nodes[0].op)
    if not outs:
        return  # every result died unread
    structure = [(n.fn, n.kwargs, n.specs) for n in nodes]
    want = [i for i, _ in outs]
    _engine.dispatch_counter.count += 1
    if len(nodes) == 1:  # an op and then a sync: the op itself
        results = _run_chain(structure, leaves, want)
    else:
        prog = _PROGRAMS.pop(key, None)
        if prog is None:
            _engine.bulk_compile_counter.bump(
                note="bulk[%s]" % ",".join(n.op for n in nodes))
            prog = _WindowProgram(structure, leaves, want, device) \
                if device.type == "cuda" else structure
            if len(_PROGRAMS) >= PROGRAM_CAP:
                _PROGRAMS.pop(next(iter(_PROGRAMS)))
        _PROGRAMS[key] = prog
        if _profiler.is_running():
            with _profiler.bulk_scope([n.op for n in nodes]):
                results = prog(leaves) if device.type == "cuda" else \
                    _run_chain(structure, leaves, want)
        else:
            results = prog(leaves) if device.type == "cuda" else \
                _run_chain(structure, leaves, want)
    for (_, arr), val in zip(outs, results):
        arr._buf = val
        arr._lazy = None


_engine._flush_hook = _flush_window


def _normalize_key(key):
    if isinstance(key, NDArray):
        return key._data.to(torch.int64)
    if isinstance(key, tuple):
        return tuple(_normalize_key(k) for k in key)
    return key


def _set_index(t, key, v):
    if isinstance(v, torch.Tensor):
        v = v.to(device=t.device, dtype=t.dtype)
    t[key] = v


def _getitem(x, key):
    nk = _normalize_key(key)
    keys = nk if isinstance(nk, tuple) else (nk,)
    if not any(isinstance(k, torch.Tensor) for k in keys):
        return invoke("_basic_index", (x,), {"key": nk})
    if isinstance(nk, torch.Tensor):
        return invoke("take", (x, NDArray(nk)), {"axis": 0, "mode": "clip"})
    rec = autograd.is_recording()
    with torch.set_grad_enabled(rec):
        return NDArray(unwrap(x, rec)[nk])


@register_op("_basic_index")
def _basic_index(x, *, key):
    """``x[key]`` for a key of ints, slices, ``None`` and ``...``."""
    return basic_index(x, key)


# ---------------------------------------------------------------- creation


def _device(ctx):
    return resolve_device(ctx or current_context())


def _dtype(dtype, default=torch.float32):
    return resolve_dtype(dtype) or default


# with no dtype asked, the JAX package's arrays are 32-bit (x64 is off)
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def array(source_array, ctx=None, dtype=None):
    """An NDArray of ``source_array`` on ``ctx`` (default: the current
    context). With no ``dtype`` float64 becomes float32 and int64 int32,
    as in the JAX package."""
    device = _device(ctx)
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach()
        if dtype is None and t.dtype == torch.float64:
            t = t.to(torch.float32)
    else:
        a = np.asarray(source_array)
        if dtype is None:
            a = a.astype(_NARROW.get(a.dtype, a.dtype), copy=False)
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None:
        t = t.to(resolve_dtype(dtype))
    return NDArray(t.to(device, copy=True))


def zeros(shape, ctx=None, dtype=None):
    return NDArray(torch.zeros(shape, dtype=_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None):
    return NDArray(torch.ones(shape, dtype=_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None):
    return NDArray(torch.full(shape, val, dtype=_dtype(dtype),
                              device=_device(ctx)))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    a = torch.arange(start, stop, step, dtype=_dtype(dtype),
                     device=_device(ctx))
    if repeat > 1:
        a = a.repeat_interleave(repeat)
    return NDArray(a)


def linspace(start, stop, num, endpoint=True, ctx=None, dtype=None):
    a = np.linspace(start, stop, num, endpoint=endpoint)
    return NDArray(torch.from_numpy(a).to(device=_device(ctx),
                                          dtype=_dtype(dtype)))


def eye(N, M=None, k=0, ctx=None, dtype=None):
    return NDArray(torch.from_numpy(np.eye(N, M, k)).to(
        device=_device(ctx), dtype=_dtype(dtype)))


def concat(*arrays, dim=1):
    return invoke("concat", arrays, {"dim": dim})


def stack(*arrays, axis=0):
    return invoke("stack", arrays, {"axis": axis})


def waitall():
    """Wait for every launched op (ref: ndarray.py:waitall → the engine's
    WaitForAll): the bulk window flushes, then a device synchronize when
    CUDA is present."""
    _engine.flush()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def save(fname, data):
    """Write NDArrays in the JAX package's container (ref:
    ndarray/utils.py:save): an npz with ``l:%08d`` keys for a list (or one
    array) or ``d:<name>`` keys for a dict, and ``__kind__``; bfloat16 and
    fp8 entries keep their bits (``util.save_npz_exact``). Either package
    loads the other's files."""
    from .util import save_npz_exact

    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not all(isinstance(v, NDArray) for v in data):
            raise ValueError("save requires NDArray elements")
        payload = {"l:%08d" % i: v._data for i, v in enumerate(data)}
        payload["__kind__"] = np.int8(0)
    elif isinstance(data, dict):
        if not all(isinstance(k, str) and isinstance(v, NDArray)
                   for k, v in data.items()):
            raise ValueError("save requires str keys and NDArray values")
        payload = {"d:" + k: v._data for k, v in data.items()}
        payload["__kind__"] = np.int8(1)
    else:
        raise ValueError("data must be NDArray, list of NDArray, or "
                         "dict of str to NDArray, got %s" % type(data))
    save_npz_exact(fname, payload)


def load(fname, ctx=None):
    """The list or dict :func:`save` wrote (either package's), on ``ctx``
    (default: the current context)."""
    from .util import load_npz_exact

    f = load_npz_exact(fname)
    device = _device(ctx)
    keys = [k for k in f if k != "__kind__"]
    kind = int(f["__kind__"]) if "__kind__" in f else (
        0 if keys and all(k.startswith("l:") for k in keys) else 1)
    if kind == 0:
        return [NDArray(f[k].to(device)) for k in sorted(keys)]
    return {k[2:] if k.startswith("d:") else k: NDArray(f[k].to(device))
            for k in keys}
