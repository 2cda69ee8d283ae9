"""The Module API (counterpart of ``mxnet_tpu/module.py``; ref:
python/mxnet/module/module.py, bucketing_module.py, sequential_module.py).

A :class:`Module` trains a Symbol graph through the port's
:class:`~mxnet_tpu_torch.symbol.Executor`: on a CUDA device each
(``is_train``, input signature) is one captured forward graph and one
backward graph, and every forward copies each argument's current tensor
into the graphs' inputs, so an update or a BatchNorm write-back is read
at the next forward. The parameters are NDArrays shared with the
executor's ``arg_dict``; :meth:`Module.update` steps them in place (the
optimizer's fused multi-tensor step) and the training forward writes
BatchNorm's moving statistics back into theirs. A ``SoftmaxOutput`` head
backpropagates MXNet's ``(prob - onehot) / N``.

``predict`` runs a deterministic eval graph through one pooled program:
a :class:`~mxnet_tpu_torch.gluon.SymbolBlock` over the graph under a
:class:`~mxnet_tpu_torch.serve.executor_pool.BucketedExecutor` at the
bound batch (the last, padded batch included). A graph that draws in eval
mode, or a batch the pool refuses, takes the per-batch forward, as in
the JAX package; both routes are counted in ``predict_stats``.

As in the JAX package, ``fit`` takes ``eval_data`` and
``batch_end_callback`` and uses neither (``ROADMAP.md`` C.2).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from . import initializer as init_mod
from . import metric as metric_mod
from . import optimizer as opt_mod
from .base import resolve_device
from .context import current_context
from .ndarray import NDArray
from .symbol import Group, Symbol, _attr_symbols

__all__ = ["Module", "BucketingModule", "SequentialModule"]


def _tensor(a):
    if isinstance(a, NDArray):
        return a._data
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a))


class Module:
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), context=None, logger=None):
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._ctx = context if context is not None else current_context()
        self._exec = None
        self._arg_params = {}
        self._optimizer = None
        self._opt_states = {}
        self._n_main_outputs = 1
        self._aux_update_names = []
        self._pred_pool = None
        self.predict_stats = {"pool": 0, "per_batch": 0}
        self.binded = False
        self.params_initialized = False

    @property
    def _device(self):
        return resolve_device(self._ctx)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, **kwargs):
        if self.binded and not force_rebind:
            return
        shapes = {}
        for desc in list(data_shapes) + list(label_shapes or []):
            name, shape = (desc.name, desc.shape) if hasattr(desc, "name") \
                else desc
            shapes[name] = tuple(shape)
        self._data_shapes = shapes
        self._for_training = for_training
        self._inputs_need_grad = inputs_need_grad
        self._exec = None
        self._pred_pool = None
        self.binded = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Each parameter from ``arg_params``/``aux_params`` (as given: the
        module holds the array), else drawn by ``initializer`` (default
        ``Uniform(0.01)``) in float32 at the shape inferred from the bound
        shapes."""
        from . import random as _random

        assert self.binded
        given = {}
        if arg_params is None and aux_params is None and getattr(
                self, "_preloaded_params", None):
            pre_arg, pre_aux = self._preloaded_params
            given.update(pre_arg)
            given.update(pre_aux or {})
        given.update(arg_params or {})
        given.update(aux_params or {})
        initializer = initializer or init_mod.Uniform(0.01)
        inferred = self._infer_param_shapes()
        device = self._device
        gen = _random.generator(device)
        for n in self._symbol.list_arguments():
            if n in self._data_names or n in self._label_names:
                continue
            if n in given:
                v = given[n]
                self._arg_params[n] = v if isinstance(v, NDArray) \
                    else NDArray(_tensor(v).to(device))
                continue
            self._arg_params[n] = NDArray(initializer(
                n, inferred[n], torch.float32, device, gen))
        self._pred_pool = None
        self.params_initialized = True

    def _infer_param_shapes(self):
        """Every argument's shape from the bound data and label shapes
        (ref: graph_executor.cc's infer pass)."""
        from .shape_inference import format_infer_errors, infer_shapes_partial

        known = dict(self._data_shapes)
        var_shapes, _, errors = infer_shapes_partial(self._symbol, known)
        missing = [n for n, s in var_shapes.items() if s is None]
        if missing:
            raise ValueError(
                "shape inference could not determine %s from data shapes %s;"
                " declare shape= on those variables%s"
                % (missing, known, format_infer_errors(errors)))
        return var_shapes

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = getattr(self, "_for_training", True)
        feed = dict(zip(self._data_names, data_batch.data))
        if data_batch.label:
            feed.update(zip(self._label_names, data_batch.label))
        feed = {n: a if isinstance(a, NDArray) else NDArray(_tensor(a))
                for n, a in feed.items()}
        self._last_feed = feed
        if self._exec is None:
            args = dict(self._arg_params)
            for n in self._data_names + self._label_names:
                if n in feed:
                    args[n] = feed[n]
            grads = {n: NDArray(torch.zeros_like(a._data))
                     for n, a in self._arg_params.items()}
            if getattr(self, "_inputs_need_grad", False):
                for n in self._data_names:
                    grads[n] = NDArray(torch.zeros_like(feed[n]._data))
            self._exec = self._bn_aux_symbol().bind(
                feed[self._data_names[0]]._data.device, args, grads)
        self._exec.forward(is_train=bool(is_train), **feed)
        outs = self._exec.outputs
        n_main = self._n_main_outputs
        if is_train and len(outs) > n_main:
            # BatchNorm's write-back: the new moving statistics become the
            # bound arrays' values, read by the next forward
            for name, new in zip(self._aux_update_names, outs[n_main:]):
                self._arg_params[name]._data = new._data
        return outs[:n_main]

    def _bn_aux_symbol(self):
        """The bound symbol with each BatchNorm's updated moving statistics
        fetched beside the main outputs."""
        self._aux_update_names = []
        self._n_main_outputs = len(self._symbol._inputs) \
            if self._symbol._op == "_group" else 1
        items, seen, stack = [], set(), [self._symbol]
        while stack:
            s = stack.pop()
            if id(s) in seen or not isinstance(s, Symbol):
                continue
            seen.add(id(s))
            if (s._op == "BatchNorm" and len(s._inputs) >= 5
                    and s._inputs[3].is_var() and s._inputs[4].is_var()):
                items.append(Symbol("_item", [s], {"index": 1},
                                    name=s.name + "_mm_upd"))
                items.append(Symbol("_item", [s], {"index": 2},
                                    name=s.name + "_mv_upd"))
                self._aux_update_names += [s._inputs[3].name,
                                           s._inputs[4].name]
            stack.extend(s._inputs)
            stack.extend(_attr_symbols(s._attrs))
        if not items:
            return self._symbol
        mains = ([self._symbol[i] for i in range(self._n_main_outputs)]
                 if self._symbol._op == "_group" else [self._symbol])
        return Group(mains + items)

    def backward(self, out_grads=None):
        if out_grads is None and self._symbol._op == "SoftmaxOutput":
            # MXNet's head: d(logits) = (softmax - one_hot(label)) / N
            prob = self._exec.outputs[0]._data
            label = self._last_feed[self._label_names[0]]._data
            cols = torch.arange(prob.shape[-1], device=prob.device)
            onehot = (cols == label.to(torch.int32)[:, None]).to(prob.dtype)
            out_grads = [NDArray((prob - onehot) / prob.shape[0])]
        elif out_grads is None:
            out_grads = [NDArray(torch.ones_like(o._data))
                         for o in self._exec.outputs[:self._n_main_outputs]]
        elif isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        out_grads = list(out_grads)
        if len(out_grads) < self._n_main_outputs:
            raise ValueError("backward needs %d output gradients, got %d"
                             % (self._n_main_outputs, len(out_grads)))
        # the statistics fetches take no gradient
        out_grads += [NDArray(torch.zeros_like(o._data))
                      for o in self._exec.outputs[len(out_grads):]]
        self._exec.backward(out_grads)

    def get_outputs(self):
        return self._exec.outputs[:self._n_main_outputs]

    def get_input_grads(self):
        """(ref: base_module.py:get_input_grads) Needs
        ``bind(inputs_need_grad=True)``."""
        assert getattr(self, "_inputs_need_grad", False), \
            "bind with inputs_need_grad=True"
        return [self._exec.grad_dict[n] for n in self._data_names]

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        optimizer_params = optimizer_params or {"learning_rate": 0.01}
        self._optimizer = (optimizer if isinstance(optimizer,
                                                   opt_mod.Optimizer)
                           else opt_mod.create(optimizer, **optimizer_params))

    def update(self):
        """One optimizer step over every parameter with a gradient, in
        place, keyed by its position in name order (the moving statistics
        are written by the forward, not stepped)."""
        aux = set(self._aux_update_names)
        params, grads, states, idx = [], [], [], []
        for i, (n, p) in enumerate(sorted(self._arg_params.items())):
            if n in aux:
                continue
            g = self._exec.grad_dict.get(n)
            if g is None:
                continue
            if i not in self._opt_states:
                self._opt_states[i] = self._optimizer.create_state(
                    i, p._data)
            params.append(p._data)
            grads.append(g._data)
            states.append(self._opt_states[i])
            idx.append(i)
        self._optimizer.fused_update(params, grads, states, idx)

    def fit(self, train_data, eval_data=None, eval_metric="accuracy",
            num_epoch=1, optimizer="sgd", optimizer_params=None,
            initializer=None, batch_end_callback=None, **kwargs):
        """(ref: base_module.py:fit) ``eval_data`` and
        ``batch_end_callback`` are accepted and unused, as in the JAX
        package."""
        if not self.binded:
            first = next(iter(train_data))
            train_data.reset()
            self.bind([(n, tuple(a.shape))
                       for n, a in zip(self._data_names, first.data)],
                      [(n, tuple(a.shape))
                       for n, a in zip(self._label_names, first.label or [])])
        if not self.params_initialized:
            self.init_params(initializer)
        self.init_optimizer(optimizer=optimizer,
                            optimizer_params=optimizer_params)
        em = metric_mod.create(eval_metric)
        for epoch in range(num_epoch):
            em.reset()
            train_data.reset()
            for batch in train_data:
                self.forward_backward(batch)
                self.update()
                outs, labels = self._strip_pad(batch, self.get_outputs(),
                                               list(batch.label or []))
                em.update(labels, outs)
        return em.get()

    # -- BaseModule conveniences (ref: module/base_module.py)
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        return list(self._data_names)

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        from .io import DataDesc

        return [DataDesc(n, self._data_shapes[n]) for n in self._data_names
                if n in getattr(self, "_data_shapes", {})]

    @property
    def label_shapes(self):
        from .io import DataDesc

        return [DataDesc(n, self._data_shapes[n]) for n in self._label_names
                if n in getattr(self, "_data_shapes", {})]

    @property
    def output_shapes(self):
        _, outs, _ = self._symbol.infer_shape(
            **{n: s for n, s in getattr(self, "_data_shapes", {}).items()})
        return list(zip(self.output_names, outs))

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        """(ref: base_module.py:update_metric)"""
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        elif pre_sliced:
            labels = [l for sl in labels for l in
                      (sl if isinstance(sl, (list, tuple)) else [sl])]
        eval_metric.update(list(labels), self.get_outputs())

    @staticmethod
    def _strip_pad(batch, outs, labels):
        """Without an iterator's wrapped rows, so a metric counts each row
        once."""
        pad = getattr(batch, "pad", 0) or 0
        if not pad:
            return outs, labels
        outs = [NDArray(o._data[:o.shape[0] - pad]) for o in outs]
        labels = [NDArray(_tensor(l)[:l.shape[0] - pad]) for l in labels]
        return outs, labels

    def _predict_pool(self):
        """(pool, input names): one program at the bound batch for every
        eval batch, or (None, None) for a graph that draws in eval mode or
        lacks a parameter."""
        from .gluon.block import SymbolBlock
        from .gluon.parameter import Parameter
        from .serve.executor_pool import BucketedExecutor
        from .symbol import _graph_has_rng, _with_training, var

        if self._pred_pool is not None:
            return self._pred_pool
        self._pred_pool = (None, None)
        shapes = getattr(self, "_data_shapes", None)
        if not shapes or not self.params_initialized:
            return self._pred_pool
        arg_names = self._symbol.list_arguments()
        input_names = [n for n in self._data_names + self._label_names
                       if n in arg_names and n in shapes]
        pnames = [n for n in arg_names if n not in input_names]
        if _graph_has_rng(_with_training(self._symbol, False)) or any(
                n not in self._arg_params for n in pnames):
            return self._pred_pool
        blk = SymbolBlock(self._symbol, [var(n) for n in input_names])
        for n in pnames:
            t = self._arg_params[n]._data
            p = Parameter(n, grad_req="null", shape=tuple(t.shape),
                          dtype=t.dtype)
            p._attach(t)
            blk._params._params[n] = p
        blk.hybridize()
        fn, _ = blk.serving_fn()
        order = [p.name for p in blk.collect_params().values()]
        arrays = self._arg_params
        bucket = shapes[self._data_names[0]][0]
        self._pred_pool = (BucketedExecutor(
            fn, lambda: [arrays[n]._data for n in order], buckets=(bucket,),
            device=self._device), input_names)
        return self._pred_pool

    def _pool_batch_inputs(self, batch, input_names, rows):
        """The pool's inputs from a batch, on the module's device; an
        absent label is zeros at the bound shape (an eval output cannot
        read it row-wise)."""
        feed = dict(zip(self._data_names, batch.data))
        if batch.label:
            feed.update(zip(self._label_names, batch.label))
        ins = []
        for n in input_names:
            a = feed.get(n)
            if a is None:
                ins.append(torch.zeros((rows,) + tuple(
                    self._data_shapes[n][1:]), device=self._device))
            else:
                ins.append(_tensor(a).to(self._device))
        return ins

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """(ref: base_module.py:predict) The outputs over an iterator,
        without pad rows, concatenated on axis 0."""
        from .serve.executor_pool import PoolError

        if reset and hasattr(eval_data, "reset"):
            eval_data.reset()
        pool, input_names = self._predict_pool()
        per_batch = []
        for i, batch in enumerate(eval_data):
            if num_batch is not None and i >= num_batch:
                break
            pad = getattr(batch, "pad", 0) or 0
            if pool is not None:
                rows = batch.data[0].shape[0]
                try:
                    ins = self._pool_batch_inputs(batch, input_names, rows)
                    outs = pool.run(ins, n_real=rows - pad, to_host=False)
                except PoolError:
                    outs = None
                if outs is not None and pool.row_aligned:
                    self.predict_stats["pool"] += 1
                    per_batch.append([NDArray(o) for o in outs])
                    continue
                # an output without the batch on axis 0, or a batch the
                # bucket cannot take: the per-batch forward from here on
                pool = None
                self._pred_pool = (None, None)
            self.predict_stats["per_batch"] += 1
            self.forward(batch, is_train=False)
            outs = self.get_outputs()
            if pad:
                outs = [NDArray(o._data[:o.shape[0] - pad]) for o in outs]
            per_batch.append(outs)
        if not per_batch:
            return []
        if not merge_batches:
            return per_batch
        merged = [NDArray(torch.cat([outs[j]._data for outs in per_batch]))
                  for j in range(len(per_batch[0]))]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def score(self, eval_data, eval_metric, num_batch=None, reset=True):
        """(ref: base_module.py:score)"""
        em = metric_mod.create(eval_metric)
        em.reset()
        if reset and hasattr(eval_data, "reset"):
            eval_data.reset()
        for i, batch in enumerate(eval_data):
            if num_batch is not None and i >= num_batch:
                break
            self.forward(batch, is_train=False)
            outs, labels = self._strip_pad(batch, self.get_outputs(),
                                           list(batch.label or []))
            em.update(labels, outs)
        return em.get_name_value()

    _AUX_SUFFIXES = ("moving_mean", "moving_var", "running_mean",
                     "running_var")

    def _is_aux(self, name):
        return name in getattr(self, "_aux_update_names", ()) \
            or name.endswith(self._AUX_SUFFIXES)

    def get_params(self):
        """(arg_params, aux_params), BatchNorm's moving statistics in the
        aux dict."""
        args = {n: v for n, v in self._arg_params.items()
                if not self._is_aux(n)}
        aux = {n: v for n, v in self._arg_params.items() if self._is_aux(n)}
        return args, aux

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True, allow_extra=False):
        """Write the values into the bound arrays in place (the executor
        holds the same arrays). ``allow_extra=False`` refuses unknown
        names, ``allow_missing=False`` needs every parameter."""
        given = dict(arg_params or {})
        given.update(aux_params or {})
        known = set(self._arg_params)
        if not known:
            warnings.warn(
                "set_params before bind/init_params: parameter names cannot "
                "be validated against the module — a misspelled name would "
                "be silently unused; prefer binding first")
            for n, v in given.items():
                self._arg_params[n] = v if isinstance(v, NDArray) \
                    else NDArray(_tensor(v))
            return
        extra = sorted(set(given) - known)
        if extra and not allow_extra:
            raise ValueError(
                "set_params: unknown parameter(s) %s (module has %s...); "
                "pass allow_extra=True to ignore"
                % (extra[:5], sorted(known)[:5]))
        missing = sorted(known - set(given))
        if missing and not allow_missing:
            raise ValueError(
                "set_params: missing parameter(s) %s; pass "
                "allow_missing=True to keep current values" % (missing[:5],))
        kept = []
        for n, v in given.items():
            if n not in known:
                continue
            new = _tensor(v)
            cur = self._arg_params[n]
            if tuple(new.shape) != tuple(cur._data.shape):
                raise ValueError(
                    "set_params: %r has shape %s; module expects %s"
                    % (n, tuple(new.shape), tuple(cur._data.shape)))
            if not force_init:
                kept.append(n)
            else:
                cur._data = new.to(device=cur._data.device,
                                   dtype=cur._data.dtype)
        if kept:
            warnings.warn("set_params: force_init=False kept %d already-"
                          "initialized parameter(s) (e.g. %r)"
                          % (len(kept), kept[0]))

    def save_checkpoint(self, prefix, epoch):
        """``prefix-symbol.json`` and ``prefix-%04d.params`` (ref:
        module/module.py:save_checkpoint)."""
        from . import model as _model

        arg, aux = self.get_params()
        _model.save_checkpoint(prefix, epoch, self._symbol, arg, aux)

    @staticmethod
    def load(prefix, epoch, data_names=("data",),
             label_names=("softmax_label",), context=None, **kwargs):
        """(ref: module/module.py:Module.load) The parameters apply at
        ``init_params``, on the module's device."""
        from . import model as _model

        sym, arg, aux = _model.load_checkpoint(prefix, epoch)
        mod = Module(sym, data_names, label_names, context, **kwargs)
        device = mod._device
        mod._preloaded_params = (
            {k: NDArray(v._data.to(device)) for k, v in arg.items()},
            {k: NDArray(v._data.to(device)) for k, v in aux.items()})
        return mod


class BucketingModule(Module):
    """(ref: module/bucketing_module.py) One executor a bucket key, every
    bucket sharing the parameter arrays and the optimizer states."""

    def __init__(self, sym_gen, default_bucket_key=None, context=None,
                 **kwargs):
        self._sym_gen = sym_gen
        self._default_key = default_bucket_key
        sym, data_names, label_names = sym_gen(default_bucket_key)
        super().__init__(sym, data_names, label_names, context)
        self._buckets = {}
        self._curr_module = None

    def switch_bucket(self, bucket_key, data_shapes=None):
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._sym_gen(bucket_key)
            m = Module(sym, data_names, label_names, self._ctx)
            m._arg_params = self._arg_params
            m._opt_states = self._opt_states
            self._buckets[bucket_key] = m
        m = self._buckets[bucket_key]
        m._optimizer = getattr(self, "_optimizer", None)
        self._curr_module = m
        return m

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", None)
        key = self._default_key if key is None else key
        return self.switch_bucket(key).forward(data_batch, is_train)

    def _predict_pool(self):
        # each batch picks its bucket's graph: the per-bucket executors are
        # the cache
        return None, None

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self):
        return self._curr_module.get_outputs()

    @property
    def _exec(self):
        if getattr(self, "_curr_module", None) is not None:
            return self._curr_module._exec
        return self.__dict__.get("_exec_base")

    @_exec.setter
    def _exec(self, v):
        self.__dict__["_exec_base"] = v


class SequentialModule:
    """(ref: module/sequential_module.py) Module i's outputs are module
    i+1's data; later modules bind with ``inputs_need_grad`` so the
    backward hands each stage's input gradients to the one before."""

    def __init__(self, logger=None):
        self._modules = []
        self._take_labels = []
        self.binded = False
        self.params_initialized = False

    def add(self, module, take_labels=False):
        if self.binded:
            raise RuntimeError("add() after bind()")
        self._modules.append(module)
        self._take_labels.append(bool(take_labels))
        return self

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, **kwargs):
        if self.binded and not force_rebind:
            return
        assert self._modules, "add() at least one module before bind()"
        cur = [(n, tuple(s)) for n, s in data_shapes]
        for i, m in enumerate(self._modules):
            lab = label_shapes if self._take_labels[i] else None
            need = inputs_need_grad if i == 0 else for_training
            m.bind(cur, lab, for_training=for_training,
                   inputs_need_grad=need, force_rebind=force_rebind)
            feed = dict(cur)
            if lab:
                feed.update({n: tuple(s) for n, s in lab})
            if i + 1 < len(self._modules):
                _, out_shapes, _ = m._symbol.infer_shape(**feed)
                nxt = self._modules[i + 1]
                if len(nxt._data_names) > len(out_shapes):
                    raise ValueError(
                        "module %d expects %d inputs but module %d emits %d "
                        "outputs" % (i + 1, len(nxt._data_names), i,
                                     len(out_shapes)))
                cur = list(zip(nxt._data_names, out_shapes))
        self._for_training = for_training
        self._inputs_need_grad = inputs_need_grad
        self.binded = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    **kwargs):
        assert self.binded
        for m in self._modules:
            m.init_params(initializer=initializer, arg_params=arg_params,
                          aux_params=aux_params, allow_missing=True,
                          allow_extra=True,
                          **{k: v for k, v in kwargs.items()
                             if k not in ("allow_missing", "allow_extra")})
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        for m in self._modules:
            m.init_optimizer(**kwargs)

    def forward(self, data_batch, is_train=None):
        from .io import DataBatch

        batch = data_batch
        for i, m in enumerate(self._modules):
            label = data_batch.label if self._take_labels[i] else []
            batch = DataBatch(data=list(batch.data if i == 0 else
                                        self._modules[i - 1].get_outputs()),
                              label=label)
            m.forward(batch, is_train=is_train)
        return self._modules[-1].get_outputs()

    def backward(self, out_grads=None):
        grads = out_grads
        for i in reversed(range(len(self._modules))):
            m = self._modules[i]
            m.backward(grads)
            if i > 0:
                grads = m.get_input_grads()

    def update(self):
        for m in self._modules:
            m.update()

    def get_outputs(self):
        return self._modules[-1].get_outputs()

    def get_input_grads(self):
        assert self._inputs_need_grad
        return self._modules[0].get_input_grads()

    def get_params(self):
        arg, aux = {}, {}
        for m in self._modules:
            a, x = m.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux
