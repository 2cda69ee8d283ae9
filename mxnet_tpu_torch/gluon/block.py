"""Block / HybridBlock (ref: python/mxnet/gluon/block.py; the JAX package's
``mxnet_tpu/gluon/block.py``).

Both are ``torch.nn.Module``s, and a layer still writes
``hybrid_forward(F, x, ..., **params)`` with ``F`` the port's functional ops.
Name scopes and prefixes follow the JAX package exactly (an auto-named root
gets ``<classname><n>_``, children nest under their parent's prefix), so a
model's parameter names match the JAX package's one to one up to the root's
counter. The port runs eagerly: there is no trace. ``hybridize()`` runs a
block's calls through CUDA graphs of its forward and backward
(``gluon/hybrid.py``). A forward builds a torch autograd graph only inside
``autograd.record()``, as in MXNet.

A block called with NDArray arguments returns NDArrays, as the JAX
package's does; called with tensors it returns tensors. The NDArray layer
is only at the outermost call: the arguments (and the NDArrays in a list
or tuple argument, a recurrent layer's states) are unwrapped once, the
children see tensors, and the outputs are wrapped once.

``save_parameters``/``load_parameters`` write and read the JAX package's
parameter files (``util.save_npz_exact`` under structural names such as
``blocks.0.attn.qkv.weight``), so a file either package writes loads in the
other with identical bits; ``load_parameters`` also reads the legacy files
keyed by global names (``ParameterDict.save``).
"""
from __future__ import annotations

import functools
import re
import threading
from collections import OrderedDict

import torch

from .. import autograd, ops
from ..base import resolve_device
from ..ndarray import NDArray, unwrap, wrap
from ..parallel import tensor_parallel as _tp
from . import hybrid as _hybrid
from ..util import load_npz_exact, save_npz_exact
from .parameter import Parameter, ParameterDict

_naming = threading.local()
# serving_fn's parameter override: {id(Parameter): tensor} while a pure call
# runs on this thread, else absent
_param_store = threading.local()
# a symbolic trace on this thread: .vars {parameter name: its variable}
_sym_trace = threading.local()


def _auto_name(hint):
    if not hasattr(_naming, "counters"):
        _naming.counters = {}
    cnt = _naming.counters.get(hint, 0)
    _naming.counters[hint] = cnt + 1
    return "%s%d_" % (hint, cnt)


class _BlockScope:
    _tls = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}

    @staticmethod
    def current():
        stack = getattr(_BlockScope._tls, "stack", None)
        return stack[-1] if stack else None

    @staticmethod
    def create(prefix, params, hint):
        current = _BlockScope.current()
        if current is None:
            if prefix is None:
                prefix = _auto_name(hint)
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            cnt = current._counter.get(hint, 0)
            current._counter[hint] = cnt + 1
            prefix = "%s%d_" % (hint, cnt)
        full_prefix = current._block.prefix + prefix
        if params is None:
            params = ParameterDict(full_prefix)
        else:
            params = ParameterDict(params.prefix, params)
        return full_prefix, params

    def __enter__(self):
        if not hasattr(_BlockScope._tls, "stack"):
            _BlockScope._tls.stack = []
        _BlockScope._tls.stack.append(self)
        return self

    def __exit__(self, *a):
        _BlockScope._tls.stack.pop()


def _is_nd(a):
    """An NDArray, or a list or tuple holding one (a recurrent layer's
    states)."""
    return isinstance(a, NDArray) or (isinstance(a, (list, tuple)) and any(
        isinstance(x, NDArray) for x in a))


def _any_ndarray(args, kwargs):
    return any(_is_nd(a) for a in args) or any(
        _is_nd(v) for v in kwargs.values())


def _is_sym(a):
    from ..symbol import Symbol

    return isinstance(a, Symbol) or (isinstance(a, (list, tuple)) and any(
        isinstance(x, Symbol) for x in a))


def _replay_call(block, *args, **kwargs):
    """``block``'s call run through its own ops, its programs (and its
    children's) set aside: what ``autograd.get_symbol`` replays."""
    with _hybrid._Body():
        return torch.nn.Module.__call__(block, *args, **kwargs)


def _any_symbol(args, kwargs):
    return any(_is_sym(a) for a in args) or any(
        _is_sym(v) for v in kwargs.values())


def _unwrap(a, rec):
    if isinstance(a, (list, tuple)):
        return type(a)(unwrap(x, rec) for x in a)
    return unwrap(a, rec)


def _trace_var(param):
    """In a symbolic trace, the parameter's named variable (one per name
    for the trace: a tied weight is one graph input), else None."""
    tvars = getattr(_sym_trace, "vars", None)
    if tvars is None:
        return None
    if param.name not in tvars:
        from .. import symbol

        tvars[param.name] = symbol.var(
            param.name, shape=param.shape if param._shape_known() else None)
    return tvars[param.name]


def param_block(param):
    """A parameter's tensor as the current call holds it: the serving_fn
    override when one is active on this thread, else ``param._tensor()``.
    Inside a ``tensor_parallel.tp_scope`` that may be this rank's block of
    a split leaf, which only a split layer reads as it is. In a symbolic
    trace, the parameter's variable."""
    v = _trace_var(param)
    if v is not None:
        return v
    store = getattr(_param_store, "params", None)
    if store is not None:
        return store[id(param)]
    return param._tensor()


def param_value(param):
    """A parameter's whole tensor as the current call sees it
    (:func:`param_block`; inside a ``tp_scope`` a split leaf's block is
    all-gathered). Used for weight tying across blocks (BERT's MLM
    decoder). In a symbolic trace, the parameter's variable."""
    v = _trace_var(param)
    if v is not None:
        return v
    t = param_block(param)
    scope = _tp.current_scope()
    return t if scope is None else scope.whole(t)


class Block(torch.nn.Module):
    """(ref: gluon/block.py:Block)"""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = OrderedDict()

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self):
        return self._params

    def name_scope(self):
        return self._scope

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            children = self.__dict__.get("_children")
            if children is not None:
                children[name] = value
        elif isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        name = name or str(len(self._children))
        self._children[name] = block
        self.add_module(name, block)
        return block

    def collect_params(self, select=None):
        ret = ParameterDict(self._params.prefix)
        pattern = re.compile(select) if select else None
        ret.update({k: v for k, v in self._own_items()
                    if pattern is None or pattern.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def _own_items(self):
        items = list(self._params.items())
        seen = {id(p) for _, p in items}
        items += [(p.name, p) for p in self._reg_params.values()
                  if id(p) not in seen]
        return items

    def _collect_params_with_prefix(self, prefix=""):
        """Parameters keyed by structural names (``0.weight``,
        ``blocks.1.ln1.gamma``) relative to this block. They do not depend
        on the auto-numbered prefixes (``dense0_`` in one process,
        ``dense20_`` in another), which is what makes parameter files
        portable. A parameter shared between blocks appears under each of
        its names."""
        if prefix:
            prefix += "."
        ret = {}
        bp = self._params.prefix
        for gname, p in self._own_items():
            local = gname[len(bp):] if bp and gname.startswith(bp) else gname
            ret[prefix + local] = p
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter under its structural name, dtype-exact
        (bf16 stays bf16). With ``deduplicate`` a shared parameter is
        written once, under its first name; any of its names loads it."""
        params = self._collect_params_with_prefix()
        uninit = [n for n, p in params.items() if p._data is None]
        if uninit:
            raise RuntimeError(
                "save_parameters: parameters %s are not initialized "
                "(deferred shapes: run one forward first)" % uninit[:5])
        arrays, seen = {}, set()
        for name, p in params.items():
            if deduplicate and id(p) in seen:
                continue
            seen.add(id(p))
            arrays[name] = p._tensor()
        save_npz_exact(filename, arrays)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Set the parameters from a file ``save_parameters`` wrote (either
        package's). A parameter keeps its device; one that holds no value
        yet goes to ``ctx`` (default: the current CUDA device). Each value
        is cast to the parameter's dtype, or with ``cast_dtype`` and
        ``dtype_source="saved"`` the parameter takes the file's dtype.
        A file keyed by global names (the legacy ``ParameterDict.save``
        format) is read by those names."""
        params = self._collect_params_with_prefix()
        loaded = load_npz_exact(filename)
        if loaded and params and not set(loaded) & set(params):
            glob = {p.name: p for p in params.values()}
            if set(loaded) & set(glob):
                params = glob
        # a shared Parameter appears under several names; a deduplicated
        # file holds only the first, so take the value from any of them
        by_id = {}
        for name, p in params.items():
            by_id.setdefault(id(p), []).append(name)
        device = None
        for name, p in params.items():
            key = name if name in loaded else next(
                (a for a in by_id[id(p)] if a in loaded), None)
            if key is None:
                if not allow_missing:
                    raise KeyError("Parameter %s missing in file %s"
                                   % (name, filename))
                continue
            value = loaded[key]
            if cast_dtype and dtype_source == "saved":
                p.cast(value.dtype)
            if p._data is None:
                if device is None:
                    device = resolve_device(ctx)
                value = value.to(device)
            p.set_data(value)
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise KeyError("Extra parameters in file: %s" % sorted(extra))

    def initialize(self, init=None, device=None, generator=None,
                   force_reinit=False):
        """Initialize every parameter on ``device`` (default: the current
        CUDA device; raises without one unless ``device='cpu'``). Random
        draws come from ``generator``, by default a generator on that device
        seeded with 0."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.collect_params().initialize(init, device, generator,
                                         force_reinit)

    def hybridize(self, active=True, **kwargs):
        """Hybridize every HybridBlock below (``HybridBlock.hybridize``)."""
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class HybridBlock(Block):
    """(ref: gluon/block.py:HybridBlock)"""

    _programs = None  # gluon.hybrid.BlockPrograms once hybridized
    _active = False

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  validate=False, **kwargs):
        """Run this block's calls through CUDA graphs of its forward and,
        under ``autograd.record``, its backward (``gluon/hybrid.py``):
        one program a key (the training flag, whether the call
        differentiates, the inputs' signature), its children inside it.
        ``hybridize``, ``hybridize(False)`` and ``cast`` drop the
        programs. On the CPU the calls run eagerly with the same keys and
        counts. ``static_alloc`` and ``static_shape`` are what a CUDA graph
        is anyway; ``validate`` (the JAX package's trace-time lint) has no
        counterpart yet (``ROADMAP.md`` A.16)."""
        from .hybrid import BlockPrograms

        if self._programs is None:
            self._programs = BlockPrograms(self)
        else:
            self._programs.drop()
        self._active = bool(active)
        for p in self.collect_params().values():
            p._hybridized = self._active
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, validate=validate,
                          **kwargs)

    def hybrid_stats(self):
        """The counts of this block's programs (``BlockPrograms.stats``),
        or None when it was never hybridized."""
        return None if self._programs is None else dict(
            self._programs.stats)

    def cast(self, dtype):
        if self._programs is not None:
            self._programs.drop()
        super().cast(dtype)

    def infer_shape(self, *args):
        """Layer hook: set deferred parameter shapes from input shapes."""

    def _ensure_params(self, *args):
        need = [p for p in self._reg_params.values() if p._data is None]
        if need:
            self.infer_shape(*[a for a in args
                               if isinstance(a, torch.Tensor)])
            for p in need:
                if p._deferred_init is not None and p._shape_known():
                    p._finish_deferred_init()

    def __call__(self, *args, **kwargs):
        if _any_ndarray(args, kwargs):
            rec = autograd.is_recording()
            args = [_unwrap(a, rec) for a in args]
            kwargs = {k: _unwrap(v, rec) for k, v in kwargs.items()}
            out = super().__call__(*args, **kwargs)
            if rec:  # autograd.get_symbol replays the block's own ops
                autograd._record_entry(functools.partial(_replay_call, self),
                                       args, kwargs, out)
            return wrap(out)
        return super().__call__(*args, **kwargs)

    def forward(self, *args, **kwargs):
        if _any_symbol(args, kwargs):
            return self._symbolic_forward(*args, **kwargs)
        self._ensure_params(*args)
        # a serving_fn call reads its own parameter tensors, which a
        # captured program does not: it runs eagerly (inside the server's
        # own bucket graph)
        if self._active and not _hybrid.inside_program() and getattr(
                _param_store, "params", None) is None and all(
                p._data is not None for p in self.collect_params().values()):
            if kwargs:
                raise TypeError("a hybridized %s takes its inputs "
                                "positionally, got %s" % (
                                    type(self).__name__, sorted(kwargs)))
            return self._programs(args)
        return self._eager_forward(*args, **kwargs)

    def _eager_forward(self, *args, **kwargs):
        with torch.set_grad_enabled(autograd.is_recording()):
            pkwargs = {n: param_value(p) for n, p in self._reg_params.items()}
            return self.hybrid_forward(ops.F, *args, **pkwargs, **kwargs)

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError

    def _symbolic_forward(self, *args, **kwargs):
        """Symbols in, a Symbol graph out, as MXNet's
        ``net(mx.sym.var('data'))``: ``hybrid_forward(sym, ...)`` with each
        parameter a named variable (its declared shape when known, so a
        model's shape-dependent code infers through the graph; weight
        tying through :func:`param_value`)."""
        from .. import sym

        pkwargs = {n: sym.var(p.name,
                              shape=p.shape if p._shape_known() else None)
                   for n, p in self._reg_params.items()}
        outer = getattr(_sym_trace, "vars", None)
        if outer is None:
            _sym_trace.vars = {}
        try:
            return self.hybrid_forward(sym, *args, **pkwargs, **kwargs)
        finally:
            if outer is None:
                _sym_trace.vars = None

    def export(self, path, epoch=0, input_names=("data",),
               input_shapes=None):
        """Write ``path-symbol.json`` and ``path-%04d.params`` (ref:
        gluon/block.py:HybridBlock.export): the block traced on one
        variable per input (with its shape from ``input_shapes``, for a
        model whose trace reads shapes) and every parameter under its name,
        dtype-exact (``util.save_npz_exact``), the files the JAX package's
        ``SymbolBlock.imports`` reads too. A shape the trace reads is baked
        into the graph's attrs (a ``reshape`` to the export batch), as in
        the JAX package. Returns the two paths."""
        from .. import symbol

        if isinstance(input_names, str):
            input_names = [input_names]
        shapes = input_shapes or [None] * len(input_names)
        ins = [symbol.var(n, shape=s) for n, s in zip(input_names, shapes)]
        out = self(*ins)
        if isinstance(out, (list, tuple)):
            out = symbol.Group(list(out))
        sym_file = "%s-symbol.json" % path
        out.save(sym_file)
        params_file = "%s-%04d.params" % (path, epoch)
        save_npz_exact(params_file, {p.name: p._tensor().detach()
                                     for p in self.collect_params().values()})
        return sym_file, params_file

    def serving_fn(self):
        """The eval-mode function of this block for the serving pool:
        ``fn(param_tensors, *inputs) -> outputs``, with the parameters read
        from ``param_tensors`` (in ``collect_params()`` order) instead of
        the Parameters, and the current tensors."""
        plist = list(self.collect_params().values())
        for p in plist:
            if p._data is None and not (p._deferred_init is not None
                                        and p._shape_known()):
                raise RuntimeError(
                    "serving_fn: parameter %r has no materialized shape — run "
                    "one forward (or initialize with explicit shapes) before "
                    "serving" % p.name)

        def pure(pa, *xs):
            prev = getattr(_param_store, "params", None)
            _param_store.params = {id(p): a for p, a in zip(plist, pa)}
            try:
                return self(*xs)
            finally:
                _param_store.params = prev

        return pure, [p._tensor() for p in plist]


class SymbolBlock(HybridBlock):
    """A block over a Symbol graph (ref: gluon/block.py:SymbolBlock): the
    graph's input variables are the call's arguments, every other free
    variable a parameter of the same name.

    A call with tensors (or NDArrays) evaluates the graph, reading the
    parameters as ``param_value`` does (so a serving override and a
    ``ModelServer`` work as for any block); the block is hybridized at
    construction, so on a CUDA device its calls replay one CUDA graph a
    key (``gluon/hybrid.py``): the cached eval pool. A call with Symbols
    splices the graph into the caller's trace (every argument a Symbol,
    one per input, or it raises)."""

    @classmethod
    def imports(cls, symbol_file, input_names, param_file=None, ctx=None):
        """(ref: gluon/block.py:SymbolBlock.imports) The graph of
        ``symbol_file`` (either package's) as a block, its parameters from
        ``param_file`` on ``ctx`` (default: the current CUDA device), each
        in the file's dtype (a bf16 export reloads as bf16)."""
        from .. import symbol

        out = symbol.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        blk = cls(out, [symbol.var(n) for n in input_names])
        if param_file is not None:
            device = resolve_device(ctx)
            loaded = load_npz_exact(param_file)
            for name in out.list_arguments():
                if name in input_names or name not in loaded:
                    continue
                arr = loaded[name]
                p = Parameter(name, shape=tuple(arr.shape), dtype=arr.dtype)
                p.set_data(arr.to(device))
                blk._params._params[name] = p
        blk.hybridize()
        return blk

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        self._outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
            else [outputs]
        self._inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]

    def _heads(self):
        from ..symbol import _heads

        return [h for o in self._outputs for h in _heads(o)]

    def forward(self, *args):
        from ..symbol import Symbol, _substitute

        if any(isinstance(a, Symbol) for a in args):
            if not all(isinstance(a, Symbol) for a in args):
                raise TypeError(
                    "SymbolBlock symbolic call requires ALL inputs to be "
                    "Symbols; mixing in arrays would splice raw data into "
                    "the graph (wrap constants in sym.var + bind instead)")
            if len(args) != len(self._inputs):
                raise TypeError(
                    "SymbolBlock symbolic call got %d inputs, graph has %d "
                    "(%s) — an unbound input var would only fail much later"
                    % (len(args), len(self._inputs),
                       ", ".join(s.name for s in self._inputs)))
            mapping = {s.name: a for s, a in zip(self._inputs, args)}
            outs = _substitute(self._heads(), mapping)
            return outs[0] if len(outs) == 1 else outs
        return super().forward(*args)

    def _eager_forward(self, *args):
        from ..symbol import _eval_symbols

        feed = {s.name: a for s, a in zip(self._inputs, args)}
        params = self.collect_params()
        for name in {a for o in self._outputs for a in o.list_arguments()}:
            if name not in feed:
                if name not in params:
                    raise KeyError("SymbolBlock: variable %r is neither an "
                                   "input nor a loaded parameter" % name)
                feed[name] = param_value(params[name])
        with torch.set_grad_enabled(autograd.is_recording()):
            outs = _eval_symbols(self._heads(), feed)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def hybrid_forward(self, F, *args, **kwargs):
        raise RuntimeError("SymbolBlock executes its graph directly")
