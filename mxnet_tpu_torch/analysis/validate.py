"""graphlint stage 2: run-time validation of hybridizable blocks
(counterpart of ``mxnet_tpu/analysis/validate.py``).

Stage 1 can only suspect a hazard; this module runs the block and proves
it, under the JAX package's rule IDs. The JAX package finds them as a
tracer's errors and by comparing jaxprs; the port has no tracer, so it
watches the run:

GL101  a host read during the forward: ``Tensor.item``, ``.tolist``,
       ``.numpy``, ``.cpu()``, ``__bool__``/``__float__``/``__int__`` (of
       a value not from the inputs), ``NDArray.asnumpy``/``asscalar``,
       seen by a ``TorchFunctionMode``; on the card also any sync
       ``torch.cuda.set_sync_debug_mode("error")`` raises on (put back
       afterwards). Inside a captured program each one raises, or freezes
       a value.
GL102  two runs at the same inputs and seed that differ: in their outputs,
       or in their op records (``observability.costs``' record: names,
       shapes, dtypes, scalar arguments). Per-call Python state feeds the
       program, which a capture would freeze at its first value.
GL103  a parameter that reaches no output: ``torch.autograd.grad(...,
       allow_unused=True)`` gives it None (dead, or read to the host at
       build time, so the forward holds a constant instead).
GL104  ``__bool__`` (an ``if``/``while``) on a value computed from the
       inputs: data-dependent Python control flow, a host sync a step,
       frozen under capture.

Entry points: :func:`check_hybridizable` (returns the findings) and
``HybridBlock.hybridize(validate=True)`` (raises :class:`GraphlintError`
at the first forward if there are any).
"""
from __future__ import annotations

import contextlib
import traceback
from typing import List

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.weak import WeakIdKeyDictionary

from .graphlint import Finding

# the Tensor methods that read the card's value from the host
_HOST_READS = {"item", "tolist", "numpy", "cpu", "__float__", "__int__",
               "__index__", "__complex__"}
# frames of the machinery, not of the block's code: torch's, and files
# ending so
_MACHINERY = ("analysis/validate.py", "mxnet_tpu_torch/ndarray.py")


class GraphlintError(RuntimeError):
    """``hybridize(validate=True)`` found hygiene violations."""

    def __init__(self, findings: List[Finding]):
        self.findings = findings
        msgs = "\n".join("  " + f.render() for f in findings)
        super().__init__(
            "graphlint: block failed run-time validation (%d finding%s):"
            "\n%s\nFix the block, or hybridize without validate=True to "
            "skip the check." % (len(findings),
                                 "s" if len(findings) != 1 else "", msgs))


def _user_frame(frames=None):
    """(path, line) of the deepest frame of the block's own code."""
    frames = traceback.extract_stack() if frames is None else frames
    best = ("<unknown>", 0)
    for fr in frames:
        fn = fr.filename
        if "/torch/" in fn or "site-packages" in fn or fn.endswith(
                _MACHINERY):
            continue
        best = (fn, fr.lineno or 0)
    return best


class _Watch(TorchFunctionMode):
    """Records the host reads of a forward, and which tensors derive from
    its inputs (to tell GL104 from GL101)."""

    def __init__(self, inputs):
        super().__init__()
        self.reads = []          # (rule, what, path, line)
        self.tainted = WeakIdKeyDictionary()
        for t in inputs:
            self.tainted[t] = True

    def _from_inputs(self, args):
        flat, _ = torch.utils._pytree.tree_flatten(args)
        return any(isinstance(a, torch.Tensor) and a in self.tainted
                   for a in flat)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name == "__bool__":
            rule = "GL104" if self._from_inputs(args) else "GL101"
            self.reads.append((rule, "bool()") + _user_frame())
        elif name in _HOST_READS:
            self.reads.append(("GL101", ".%s()" % name.strip("_"))
                              + _user_frame())
        out = func(*args, **kwargs)
        if self._from_inputs((args, kwargs)):
            flat, _ = torch.utils._pytree.tree_flatten(out)
            for o in flat:
                if isinstance(o, torch.Tensor):
                    self.tainted[o] = True
        return out


@contextlib.contextmanager
def _ndarray_reads(watch):
    """``NDArray.asnumpy``/``asscalar`` recorded as host reads."""
    from ..ndarray import NDArray

    saved = {n: getattr(NDArray, n) for n in ("asnumpy", "asscalar")}

    def wrap(name, orig):
        def probe(self, *a, **k):
            watch.reads.append(("GL101", ".%s()" % name) + _user_frame())
            return orig(self, *a, **k)
        return probe

    for n, f in saved.items():
        setattr(NDArray, n, wrap(n, f))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(NDArray, n, f)


def _deactivated(block):
    """Every hybridized block below ``block`` set to run eagerly; returns
    [(block, previous flag)] to put back."""
    saved, stack = [], [block]
    while stack:
        b = stack.pop()
        if hasattr(b, "_active"):
            saved.append((b, b._active))
            b._active = False
        stack.extend(getattr(b, "_children", {}).values())
    return saved


def _tensors(x):
    from ..ndarray import NDArray

    flat, _ = torch.utils._pytree.tree_flatten(x)
    return [a._data if isinstance(a, NDArray) else a for a in flat
            if isinstance(a, (torch.Tensor, NDArray))]


def _probe(block, inputs, device, seed):
    """One eager forward under the watch and the op recorder, the
    device's generator seeded: (outputs, host reads, op record)."""
    from .. import random as _random
    from ..observability.costs import _Recorder

    ins = _tensors(inputs)
    watch = _Watch(ins)
    rec = _Recorder()
    actives = _deactivated(block)
    sync_mode = None
    if device.type == "cuda":
        sync_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    try:
        with _random.fork(device, seed), _ndarray_reads(watch), watch, rec:
            out = block(*inputs)
    except RuntimeError as e:
        if sync_mode is None or "synchroniz" not in str(e):
            raise
        frames = traceback.extract_tb(e.__traceback__)
        watch.reads.append(("GL101", "a synchronizing op (%s)"
                            % str(e).splitlines()[0])
                           + _user_frame(frames))
        out = None
    finally:
        if sync_mode is not None:
            torch.cuda.set_sync_debug_mode(sync_mode)
        for b, prev in actives:
            b._active = prev
    return out, watch.reads, rec.ops


def _signature(ops):
    return [[o["op"], [d[1:3] for d in o["ins"]],
             [d[1:3] for d in o["outs"]], o["scalars"]] for o in ops]


def check_hybridizable(block, *inputs, training=False):
    """Run ``block`` on ``inputs`` (tensors or NDArrays of the shapes it
    will run at) and return its findings (empty: clean). The block runs
    eagerly four times: three times under the watch (GL101, GL104; the
    first a warm-up, the two after it compared, GL102), once recording to
    differentiate its outputs with respect to its parameters (GL103). ``training``: run under
    ``autograd.train_mode``."""
    from .. import autograd

    if not hasattr(block, "hybrid_forward"):
        raise TypeError(
            "check_hybridizable needs a HybridBlock (got %s)"
            % type(block).__name__)
    scope = type(block).__name__
    ins = _tensors(inputs)
    params = [p for p in block.collect_params().values()
              if p._data is not None]
    device = ins[0].device if ins else (
        params[0]._data.device if params else torch.device("cpu"))
    mode = autograd.train_mode() if training else autograd.predict_mode()
    findings: List[Finding] = []
    with mode:
        # the first run is the warm-up (lazy set-up: deferred parameters,
        # library handles, the kernels' device queries); its host reads
        # count, and the two runs after it are compared
        _, reads, _ = _probe(block, inputs, device, 1234)
        out1, more, ops1 = _probe(block, inputs, device, 1234)
        out2, _, ops2 = _probe(block, inputs, device, 1234)
    reads = reads + more
    for rule, what, path, line in reads:
        if rule == "GL104":
            msg = ("%s on a value computed from the inputs: Python control "
                   "flow on the data (a sync a step; frozen under capture)"
                   % what)
        else:
            msg = ("%s reads the device from the host during the forward "
                   "(it raises inside a captured program)" % what)
        findings.append(Finding(path, line, rule, msg, scope))
    if out1 is not None and out2 is not None:
        a, b = _tensors(out1), _tensors(out2)
        same = len(a) == len(b) and all(
            x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))
        s1, s2 = _signature(ops1), _signature(ops2)
        if not same or s1 != s2:
            if not same:
                where = "in their outputs"
            else:
                i = next((i for i, (x, y) in enumerate(zip(s1, s2))
                          if x != y), min(len(s1), len(s2)))
                where = "in their op records, from op %d: %s against %s" % (
                    i, s1[i] if i < len(s1) else "the end",
                    s2[i] if i < len(s2) else "the end")
            findings.append(Finding(
                "<run>", 0, "GL102",
                "two runs at the same inputs and seed differ (%s): "
                "per-call Python state feeds the program, which a capture "
                "freezes at its first value" % where, scope))
    findings.extend(_dead_params(block, inputs, params, training, scope))
    return _dedup(findings)


def _dead_params(block, inputs, params, training, scope):
    """GL103: the parameters (that take a gradient) no output depends
    on."""
    from .. import autograd

    live = [p for p in params if p.grad_req != "null"]
    if not live:
        return []
    actives = _deactivated(block)
    try:
        mode = autograd.train_mode() if training else autograd.predict_mode()
        with autograd.record(), mode:
            outs = [o for o in _tensors(block(*inputs))
                    if o.requires_grad]
    finally:
        for b, prev in actives:
            b._active = prev
    tensors = [p._data for p in live]
    if not outs:
        grads = [None] * len(tensors)
    else:
        grads = torch.autograd.grad(
            [o.float().sum() for o in outs], tensors, allow_unused=True)
    return [Finding("<run>", 0, "GL103",
                    "parameter %r reaches no output (dead, or read to the "
                    "host at build time so the forward holds a constant)"
                    % p.name, scope)
            for p, g in zip(live, grads) if g is None]


def _dedup(findings: List[Finding]) -> List[Finding]:
    """One finding per (path, line, rule)."""
    seen, out = set(), []
    for f in findings:
        k = (f.path, f.line, f.rule)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out
