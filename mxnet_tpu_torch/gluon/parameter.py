"""Parameter / ParameterDict over torch tensors (ref:
python/mxnet/gluon/parameter.py; the JAX package's
``mxnet_tpu/gluon/parameter.py``).

A Parameter owns one tensor on one device. Deferred initialization works as
in MXNet: a dimension declared 0 is inferred at the first forward.

The tensor is a leaf that requires grad unless ``grad_req`` is ``"null"``,
and stays one through ``set_data``, ``cast`` and ``reset_device``; it
carries a gradient of zeros from the start, as MXNet's ``attach_grad``
does. ``autograd.backward`` stores gradients by ``grad_req``: ``"write"``
replaces the gradient, ``"add"`` adds to it (torch itself would always
add).

``data()``, ``grad()``, ``list_data()`` and ``list_grad()`` return NDArrays
that wrap the live tensors without a copy, as in the JAX package; a write
into ``data()``'s NDArray goes into the parameter. The port's own code
reads the tensor through ``_tensor()``.

``ParameterDict.save``/``load`` write and read the legacy files keyed by
global parameter names (``<prefix>dense0_weight``), in the JAX package's
exact npz format.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .. import autograd
from .. import initializer as init_mod
from ..base import resolve_device, resolve_dtype

GRAD_REQS = ("write", "add", "null")


class DeferredInitializationError(RuntimeError):
    pass


class Parameter:
    # set by HybridBlock.hybridize: the Trainer steps a set of such
    # parameters through one captured optimizer step
    _hybridized = False

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 init=None, allow_deferred_init=False):
        self.name = name
        self._data = None
        self._grad_req = "null"
        self.grad_req = grad_req
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = resolve_dtype(dtype)
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._deferred_init = None  # (initializer, device, generator)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in GRAD_REQS:
            raise ValueError("grad_req must be one of %s, got %r"
                             % (GRAD_REQS, req))
        self._grad_req = req
        if self._data is not None:
            self._attach(self._data)

    def _attach(self, tensor):
        """Hold ``tensor`` (detached) as this parameter's leaf, requiring
        grad with a zero gradient unless ``grad_req`` is ``"null"``."""
        leaf = tensor.detach()
        if self._grad_req != "null":
            leaf.requires_grad_(True)
            leaf.grad = torch.zeros_like(leaf)
        self._data = leaf

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is not None and (
                len(self._shape) != len(new_shape)
                or any(s not in (0, n) for s, n in zip(self._shape, new_shape))):
            raise ValueError("inferred shape %s incompatible with declared %s "
                             "for %s" % (new_shape, self._shape, self.name))
        self._shape = new_shape

    def _shape_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    def initialize(self, init=None, device=None, default_init=None,
                   generator=None, force_reinit=False):
        if self._data is not None and not force_reinit:
            return
        if isinstance(init, str):
            init = init_mod.create(init)
        own = init_mod.create(self.init) if isinstance(self.init, str) \
            else self.init
        self._deferred_init = (init or own or default_init
                               or init_mod.Uniform(),
                               resolve_device(device), generator)
        if self._shape_known():
            self._finish_deferred_init()
        elif not self.allow_deferred_init:
            raise ValueError("shape of Parameter %s unknown and deferred init "
                             "not allowed" % self.name)

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        initializer, device, generator = self._deferred_init
        self._attach(initializer(self.name, self._shape, self.dtype, device,
                                 generator))
        self._deferred_init = None

    def _tensor(self):
        """The live tensor (what ``data()`` wraps); a read while recording
        registers the parameter for ``autograd.backward``."""
        if self._data is None:
            if self._deferred_init is not None and self._shape_known():
                self._finish_deferred_init()
            else:
                raise DeferredInitializationError(
                    "Parameter %s not initialized (call .initialize(), and "
                    "ensure its shape is inferable)" % self.name)
        autograd.read_variable(self, self._data)
        return self._data

    def data(self, ctx=None):
        """The value as an NDArray over the live tensor."""
        from ..ndarray import NDArray

        nd = NDArray(self._tensor())
        nd._param = self
        return nd

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient as an NDArray (None when ``grad_req`` is
        ``"null"``)."""
        from ..ndarray import NDArray

        g = self._tensor().grad
        return None if g is None else NDArray(g)

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        """Reset the gradient to zeros (a fresh tensor: a gradient may be
        shared with another parameter's)."""
        if self._data is not None and self._data.grad is not None:
            self._data.grad = torch.zeros_like(self._data)

    @property
    def device(self):
        return None if self._data is None else self._data.device

    def set_data(self, data):
        """Replace the value, cast to this parameter's dtype, on its device
        (or on the value's device when the parameter holds none yet)."""
        data = getattr(data, "_data", data)  # an NDArray's tensor
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(data)
        if self._shape_known() and tuple(data.shape) != self._shape:
            raise ValueError("Parameter %r: cannot set_data with shape %s; "
                             "parameter shape is %s"
                             % (self.name, tuple(data.shape), self._shape))
        device = data.device if self._data is None else self._data.device
        value = data.to(device=device, dtype=self.dtype)
        # the optimizer updates the stored tensor in place: never alias the
        # caller's
        self._attach(value.clone() if value is data else value)
        self._shape = tuple(data.shape)
        self._deferred_init = None

    def copy_data(self, data):
        """Write ``data`` (this parameter's shape) into the live tensor in
        place, cast to its dtype: whatever holds the tensor's storage (a
        captured CUDA graph) reads the new value."""
        data = getattr(data, "_data", data)
        if tuple(data.shape) != tuple(self._tensor().shape):
            raise ValueError("Parameter %r: cannot copy_data with shape %s; "
                             "parameter shape is %s"
                             % (self.name, tuple(data.shape), self._shape))
        with torch.no_grad():
            self._data.copy_(data)

    def reset_device(self, device):
        if self._data is not None:
            self._attach(self._data.to(resolve_device(device)))

    def cast(self, dtype):
        self.dtype = resolve_dtype(dtype)
        if self._data is not None:
            self._attach(self._data.to(self.dtype))

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self._shape,
                                                      self.dtype)


class Constant(Parameter):
    """A non-differentiable parameter holding a fixed value (ref:
    gluon/parameter.py:Constant): ``grad_req`` is ``"null"``, so no
    gradient reaches it and ``Trainer`` never updates it. It is passed to
    ``hybrid_forward`` by name, saved and loaded with the other parameters,
    and cast by ``amp`` with them, as in the JAX package. ``initialize``
    sets it to its value whatever the initializer."""

    def __init__(self, name, value):
        value = torch.as_tensor(value)
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype)
        self._value = value

    def initialize(self, init=None, device=None, default_init=None,
                   generator=None, force_reinit=False):
        if self._data is not None and not force_reinit:
            return
        self._attach(self._value.to(device=resolve_device(device),
                                    dtype=self.dtype))
        self._deferred_init = None


class ParameterDict:
    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __len__(self):
        return len(self._params)

    def get(self, name, **kwargs):
        """Create-or-retrieve (ref: gluon/parameter.py:ParameterDict.get)."""
        name = self._prefix + name
        if name in self._params:
            param = self._params[name]
            shape = kwargs.get("shape")
            if shape is not None and param.shape is not None:
                param.shape = shape
            return param
        if self._shared is not None and name in self._shared:
            self._params[name] = self._shared[name]
            return self._shared[name]
        param = Parameter(name, **kwargs)
        self._params[name] = param
        return param

    def get_constant(self, name, value=None):
        """Create-or-retrieve a :class:`Constant` (ref:
        gluon/parameter.py:ParameterDict.get_constant)."""
        name = self._prefix + name
        if name not in self._params:
            if value is None:
                raise KeyError("no constant %s, and no value to create it"
                               % name)
            self._params[name] = Constant(name, value)
        return self._params[name]

    def update(self, other):
        for k, v in other.items():
            self._params[k] = v

    def initialize(self, init=None, device=None, generator=None,
                   force_reinit=False):
        for p in self.values():
            p.initialize(None, device, default_init=init, generator=generator,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def save(self, filename, strip_prefix=""):
        """Write every parameter under its global name (less
        ``strip_prefix``), dtype-exact: the legacy ParameterDict file (ref:
        gluon/parameter.py:ParameterDict.save)."""
        from ..util import save_npz_exact

        arrays = {}
        for name, p in self.items():
            if p._data is None:
                continue
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arrays[name] = p._data
        save_npz_exact(filename, arrays)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Set the parameters from a file :meth:`save` wrote (either
        package's), names prefixed with ``restore_prefix``."""
        from ..util import load_npz_exact

        loaded = {restore_prefix + k: v
                  for k, v in load_npz_exact(filename).items()}
        if not allow_missing:
            missing = [n for n in self.keys() if n not in loaded]
            if missing:
                raise KeyError("Parameters %s missing in file %s"
                               % (missing[:5], filename))
        if not ignore_extra:
            extra = [n for n in loaded if n not in self._params]
            if extra:
                raise KeyError("Extra parameters in file %s: %s"
                               % (filename, sorted(extra)[:5]))
        device = None
        for name, p in self.items():
            if name not in loaded:
                continue
            value = loaded[name]
            if p._data is None:
                if device is None:
                    device = resolve_device(ctx)
                value = value.to(device)
            p.set_data(value)

    def reset_device(self, device):
        for p in self.values():
            p.reset_device(device)

    def __repr__(self):
        return "ParameterDict(%s)\n" % self._prefix + "\n".join(
            repr(p) for p in self.values())
