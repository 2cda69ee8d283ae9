"""graphlint stage 1: the AST linter of the port's tracing hygiene
(counterpart of ``mxnet_tpu/analysis/graphlint.py``: its rule IDs, its
allowlist discipline, its rules retargeted to torch).

The port's hot path is a CUDA graph a key (a served bucket, a decode step,
a hybridized block, the optimizer's step) or an eager run of the same ops;
these hazard classes break it, with stable rule IDs:

GL001  host sync inside a hybridizable or captured region: ``.asnumpy()``,
       ``.asscalar()``, ``.wait_to_read()``, ``.tolist()``, ``.numpy()``,
       ``.cpu()``, ``float()/int()/bool()/.item()`` on tensor values,
       ``np.asarray``/``np.array`` on them. Each reads the card from the
       host: inside a capture it raises, and eagerly it stalls the stream.
GL002  rebuild hazard: a fresh ``torch.compile`` of a lambda or local
       function invoked per call (a new callable a call: a recompile a
       call), a ``torch.cuda.CUDAGraph()`` captured and dropped inside one
       call (a capture a call), or a set turned into a tuple or list
       without ``sorted`` (its order, in a program key, varies across
       processes).
GL003  leak: a value derived from a region's inputs stored on ``self`` or
       a module global inside the region; under capture it pins a graph's
       buffer that the next replay overwrites.
GL004  data-dependent Python control flow: ``if``/``while`` on a value
       derived from a region's tensors (a host sync a step; under capture
       the branch is frozen). Shape, dtype and None tests are static.
GL006  unbounded module-level cache dict: a module-level ``{}`` that
       functions insert into with no eviction or cap in sight.
GL007  growing carried state: inside a loop, a value rebound to a concat
       of itself (``x = torch.cat([x, ...])``): its shape changes every
       iteration, so every program keyed on it builds again each step.
       Host numpy accumulation is exempt.
GL008  a program built outside the counted seams: ``torch.compile(...)``,
       ``torch.cuda.CUDAGraph()`` or ``torch.cuda.graph(...)`` outside
       ``capture.py``. Builds through ``capture.capture_graph`` are the
       ones the watchdog and ``observability.costs`` see; deliberate
       exceptions carry an allowlist entry with a why.
GL009  ad-hoc metric state outside ``mxnet_tpu_torch/observability/``: a
       ``DispatchCounter(...)`` anywhere, or a module-level metric object
       (``Counter``/``Gauge``/``Histogram``/``ServeMetrics``/
       ``GenerativeMetrics``).
GL010  ad-hoc graph-node class or hand-rolled program key outside
       ``mxnet_tpu_torch/ir/``: a class with an ``op`` field beside
       ``specs``/``inputs`` wiring, or a tuple of two or more
       ``tuple(...)`` parts bound to a ``*key*`` name.
GL016  hand-rolled tuning table: a module-level literal table of block or
       bucket constants outside ``ir/tune.py``.
GL017  process spawn or kill outside the fleet layer (``serve/fleet.py``,
       ``serve/worker.py``, ``tools/``).

``NOT_APPLICABLE`` records the JAX package's rule that has no meaning in
torch (GL005, use after donation: torch has no buffer donation).

A hybridizable or captured region is: a ``hybrid_forward`` body; a
function decorated with ``register_op`` (every registered op runs inside
captured programs); a function passed by name, in the same module, to
``capture_graph`` or ``torch.compile``; a lambda handed to those inline.

Suppression: ``# graphlint: disable=GLnnn`` on the flagged line for a
one-off; repo-wide exemptions go in the committed allowlist
(``tools/torch_graphlint_allow.json``) with a ``why``. Output is
deterministic: findings sort by (path, line, rule).
"""
from __future__ import annotations

import ast
import hashlib
import json
import os
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

try:
    from . import concurrency as _conc
except ImportError:
    # tools/graphlint.py loads this module standalone (no package context);
    # load the concurrency rules the same way.
    import importlib.util as _ilu
    _conc_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "concurrency.py")
    _conc_spec = _ilu.spec_from_file_location("graphlint_concurrency",
                                              _conc_path)
    _conc = _ilu.module_from_spec(_conc_spec)
    _conc_spec.loader.exec_module(_conc)

RULES = {
    "GL001": "host sync inside a hybridizable or captured region",
    "GL002": "rebuild hazard (per-call compile or CUDA graph / unordered "
             "cache key)",
    "GL003": "leak (a region's value stored on self/global in the region)",
    "GL004": "data-dependent Python control flow in a hybridizable region",
    "GL006": "unbounded module-level cache dict",
    "GL007": "growing carried state (shape changes per loop iteration)",
    "GL008": "a program built outside the counted build seams",
    "GL009": "ad-hoc metric state outside mxnet_tpu_torch/observability",
    "GL010": "ad-hoc graph-node class / hand-rolled cache key outside "
             "mxnet_tpu_torch/ir",
    "GL016": "hand-rolled magic tuning table (literal block/bucket "
             "constants outside the tuned-config store)",
    "GL017": "process spawn/kill outside the fleet layer (serve.fleet / "
             "serve.worker / tools own replica lifecycle)",
}
RULES.update(_conc.RULES)  # GL011–GL015: concurrency rules (racecheck)

# the JAX package's rules that mean nothing in torch
NOT_APPLICABLE = {
    "GL005": "not applicable, because torch has no buffer donation: no "
             "call hands an argument's memory to its output",
}

# paths structurally exempt from GL010: the typed IR itself
_GL010_EXEMPT = ("mxnet_tpu_torch/ir/",)

# field-name evidence for a structural graph-node class: an op name next
# to input wiring
_GL010_OP_FIELDS = {"op", "_op"}
_GL010_WIRING_FIELDS = {"specs", "inputs", "_inputs", "wiring"}

# call names whose tuple-assembly into a `*key*` binding marks a
# hand-rolled program-cache key
_GL010_KEY_CALLS = {"tuple", "frozenset", "_freeze"}

# paths structurally exempt from GL008: the persistent funnel itself
_GL008_EXEMPT = ("mxnet_tpu_torch/capture.py",)

# paths structurally exempt from GL009: the metrics registry itself
_GL009_EXEMPT = ("mxnet_tpu_torch/observability/",)

# metric classes whose MODULE-LEVEL instantiation outside observability is
# ad-hoc metric state (function/method-level instances are request- or
# server-scoped and register through their owners)
_GL009_METRIC_CLASSES = {"Counter", "Gauge", "Histogram", "ServeMetrics",
                         "GenerativeMetrics"}

# paths structurally exempt from GL016: the autotuner itself (its
# candidate grids ARE the search space, not a schedule pretending to be
# tuned)
_GL016_EXEMPT = ("mxnet_tpu_torch/ir/tune.py",)

# name evidence for a tuning table: block sizes / bucket sets — the two
# schedule families ir.tune searches; a literal table under such a name
# is a hand-authored schedule the search should own (allowlist the
# deliberate defaults with a why)
_GL016_NAME_MARKERS = ("BLOCK", "BUCKET")

# paths structurally exempt from GL017: the fleet layer itself (spawning
# and killing replicas is its JOB) and tools/ (benches, launchers)
_GL017_EXEMPT = ("mxnet_tpu_torch/serve/fleet.py",
                 "mxnet_tpu_torch/serve/worker.py", "tools/")

# process-lifecycle callables: ``os.<attr>`` / ``subprocess.<attr>`` calls
# (or a bare ``Popen(...)`` from ``from subprocess import Popen``) outside
# the fleet layer scatter replica lifecycle across the codebase — workers
# leak, kill -9 drills miss them, and the router can't account for them
_GL017_OS_CALLS = {"kill", "killpg", "fork", "forkpty", "system", "popen",
                   "spawnv", "spawnl", "execv", "execve"}
_GL017_SUBPROCESS_CALLS = {"Popen", "run", "call", "check_call",
                           "check_output"}

# concat-family callables whose self-referential use in a loop grows the
# carried shape (GL007); numpy names are exempt (host accumulation)
_CONCAT_NAMES = {"concat", "concatenate", "cat", "append", "hstack",
                 "vstack"}

# attribute reads that are static (answered from the metadata, never
# a host readback) — they scrub taint
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "context", "ctx", "stype",
                 "name", "prefix", "device", "is_cuda", "requires_grad",
                 "layout", "dim", "numel", "is_floating_point",
                 "is_complex", "element_size", "stride", "is_contiguous",
                 "data_ptr", "get_device", "itemsize"}

# calls whose result is host-static even on traced operands
_SCRUB_CALLS = {"len", "isinstance", "getattr", "hasattr", "type", "id",
                "range", "enumerate", "zip"}

_SYNC_ATTRS = {"asnumpy", "asscalar", "wait_to_read", "tolist", "numpy",
               "cpu"}
_NP_NAMES = {"np", "numpy", "onp"}

# capture entry points: callable-name -> index of the captured-fn argument
_TRACE_ENTRY_ARG = {"capture_graph": 0, "compile": 0}
_JIT_NAMES = {"compile"}


class Finding(NamedTuple):
    path: str
    line: int
    rule: str
    msg: str
    scope: str  # enclosing def qualname, or the cache name for GL006

    @property
    def key(self) -> str:
        """Stable allowlist identity: survives line-number churn."""
        return "%s::%s::%s" % (self.path, self.rule, self.scope)

    def render(self) -> str:
        return "%s:%d: %s %s [%s]" % (self.path, self.line, self.rule,
                                      self.msg, self.scope)


def _call_name(func: ast.AST) -> Optional[str]:
    """Trailing name of a call target: torch.compile -> 'compile'."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_jit_decorator(dec: ast.AST) -> bool:
    """``@register_op(...)`` (every registered op runs inside captured
    programs) and ``@torch.compile`` mark a region."""
    if _call_name(dec) in (_JIT_NAMES | {"register_op"}):
        return True
    if isinstance(dec, ast.Call):
        if _call_name(dec.func) == "partial" and dec.args \
                and _call_name(dec.args[0]) in _JIT_NAMES:
            return True
        if _call_name(dec.func) in (_JIT_NAMES | {"register_op"}):
            return True
    return False


def _disabled_rules(src_lines: List[str], line: int) -> Set[str]:
    """Rules suppressed by a ``# graphlint: disable=GL001,GL002`` comment."""
    if not (1 <= line <= len(src_lines)):
        return set()
    text = src_lines[line - 1]
    marker = "graphlint: disable="
    i = text.find(marker)
    if i < 0:
        return set()
    return {r.strip() for r in text[i + len(marker):].split(",")
            if r.strip().startswith("GL")}


class _Taint:
    """Linear (source-order) intraprocedural taint over names derived from a
    region's traced inputs. Deliberately coarse — a linter, not an abstract
    interpreter: one pass, no branch sensitivity."""

    def __init__(self, seeds: Set[str]):
        self.names = set(seeds)

    def expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.expr(node.value)
        if isinstance(node, ast.Call):
            name = _call_name(node.func)
            if name in _SCRUB_CALLS:
                return False
            if self.expr(node.func):
                return True
            return any(self.expr(a) for a in node.args) or \
                any(self.expr(k.value) for k in node.keywords)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not None` are static guards, not data flow
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return self.expr(node.left) or any(self.expr(c)
                                               for c in node.comparators)
        if isinstance(node, (ast.BinOp,)):
            return self.expr(node.left) or self.expr(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.expr(v) for v in node.values)
        if isinstance(node, ast.Subscript):
            return self.expr(node.value)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.expr(node.body) or self.expr(node.orelse)
        if isinstance(node, ast.Starred):
            return self.expr(node.value)
        return False

    def assign(self, target: ast.AST):
        if isinstance(target, ast.Name):
            self.names.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self.assign(e)


class _ModuleLint:
    def __init__(self, tree: ast.Module, path: str, src: str):
        self.tree = tree
        self.path = path
        self.src_lines = src.splitlines()
        self.findings: List[Finding] = []
        self.region_names = self._collect_region_names()

    # ------------------------------------------------------------ plumbing
    def add(self, node: ast.AST, rule: str, msg: str, scope: str):
        line = getattr(node, "lineno", 0)
        if rule in _disabled_rules(self.src_lines, line):
            return
        self.findings.append(Finding(self.path, line, rule, msg, scope))

    # ---------------------------------------------------- region discovery
    def _collect_region_names(self) -> Set[str]:
        """Names of functions handed (by name) to a tracing entry point
        anywhere in the module — their bodies are traced regions."""
        names: Set[str] = set()
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            idx = _TRACE_ENTRY_ARG.get(_call_name(node.func) or "")
            if idx is None or len(node.args) <= idx:
                continue
            target = node.args[idx]
            if isinstance(target, ast.Name):
                names.add(target.id)
        return names

    def _is_region(self, fn: ast.AST) -> bool:
        if isinstance(fn, ast.Lambda):
            return False  # lambdas handled at their trace-entry call site
        if fn.name == "hybrid_forward":
            return True
        if any(_is_jit_decorator(d) for d in fn.decorator_list):
            return True
        return fn.name in self.region_names

    # ------------------------------------------------------------ top level
    def run(self) -> List[Finding]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self._is_region(node):
                    self._check_region(node)
                self._check_percall_graph(node)
            if isinstance(node, ast.ClassDef):
                self._check_node_class(node)
            if isinstance(node, ast.Assign):
                self._check_handrolled_key(node)
            if isinstance(node, ast.Call):
                self._check_percall_jit(node)
                self._check_unfunneled_jit(node)
                self._check_adhoc_metric(node)
            if isinstance(node, ast.Call) and _call_name(node.func) in (
                    "tuple", "list") and node.args:
                self._check_unordered_key(node)
            if isinstance(node, (ast.For, ast.While)):
                self._check_growing_carried(node)
        self._check_module_caches()
        self._check_tuning_tables()
        self._check_process_lifecycle()
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule, f.msg))
        return self.findings

    # ------------------------------------------------- GL001/GL003/GL004
    def _region_seeds(self, fn) -> Set[str]:
        """Traced-input names of a region. Positional args are traced;
        keyword-only args are STATIC by this codebase's convention (OpDef
        attrs, passed as keyword arguments) — except
        ``hybrid_forward``, whose ``**params`` kwargs are parameter arrays,
        and ``register_op(array_kwargs=...)`` declarations."""
        args = fn.args
        ordered = [a.arg for a in args.posonlyargs + args.args]
        skip = {"self", "cls"}
        if fn.name == "hybrid_forward" and len(ordered) >= 2:
            skip.add(ordered[1])  # F — the functional facade, not an array
        is_op = any(_call_name(d if not isinstance(d, ast.Call) else d.func)
                    == "register_op" for d in fn.decorator_list)
        if is_op and args.defaults:
            # registered ops: mandatory positional params are the array
            # inputs; defaulted ones are op attrs, passed as (static)
            # kwargs by the dispatcher
            skip.update(ordered[-len(args.defaults):])
        seeds = {a for a in ordered if a not in skip}
        if args.vararg:
            seeds.add(args.vararg.arg)
        if fn.name == "hybrid_forward":
            seeds.update(a.arg for a in args.kwonlyargs)
            if args.kwarg:
                seeds.add(args.kwarg.arg)  # **params are parameter arrays
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Call) and \
                    _call_name(dec.func) == "register_op":
                for kw in dec.keywords:
                    if kw.arg == "array_kwargs":
                        try:
                            seeds.update(ast.literal_eval(kw.value))
                        except ValueError:
                            pass
        return seeds

    def _check_region(self, fn):
        scope = fn.name
        taint = _Taint(self._region_seeds(fn))
        globals_declared: Set[str] = set()

        # one linear pass in source order: propagate taint, then check each
        # statement's hazards against the taint known so far
        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                globals_declared.update(node.names)

        # propagate to fixpoint (ast.walk is BFS, not source order; a couple
        # of sweeps make chained assignments converge regardless)
        for _ in range(4):
            before = len(taint.names)
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    if taint.expr(node.value):
                        for t in node.targets:
                            taint.assign(t)
                elif isinstance(node, ast.AugAssign):
                    if taint.expr(node.value) or taint.expr(node.target):
                        taint.assign(node.target)
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    if taint.expr(node.value):
                        taint.assign(node.target)
                elif isinstance(node, ast.For):
                    if taint.expr(node.iter):
                        taint.assign(node.target)
            if len(taint.names) == before:
                break

        for node in ast.walk(fn):
            # ---- GL001: host syncs
            if isinstance(node, ast.Call):
                name = _call_name(node.func)
                if isinstance(node.func, ast.Attribute):
                    if node.func.attr in _SYNC_ATTRS:
                        self.add(node, "GL001",
                                 ".%s() is a host readback inside a traced "
                                 "region" % node.func.attr, scope)
                    elif node.func.attr == "item" and taint.expr(node.func.value):
                        self.add(node, "GL001",
                                 ".item() on a traced value is a host "
                                 "readback", scope)
                    elif (node.func.attr in ("asarray", "array")
                          and isinstance(node.func.value, ast.Name)
                          and node.func.value.id in _NP_NAMES
                          and any(taint.expr(a) for a in node.args)):
                        self.add(node, "GL001",
                                 "np.%s() on a traced value forces device→"
                                 "host transfer" % node.func.attr, scope)
                elif name in ("float", "int", "bool") and node.args \
                        and any(taint.expr(a) for a in node.args):
                    self.add(node, "GL001",
                             "%s() on a traced value is a host readback "
                             "(a sync with the card)" % name, scope)
            # ---- GL003: leaks
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                value = node.value
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                if taint.expr(value):
                    for t in targets:
                        base = t
                        while isinstance(base, ast.Subscript):
                            base = base.value
                        if isinstance(base, ast.Attribute) and \
                                isinstance(base.value, ast.Name) and \
                                base.value.id == "self":
                            self.add(node, "GL003",
                                     "traced value stored on self.%s escapes "
                                     "the trace" % base.attr, scope)
                        elif isinstance(base, ast.Name) and \
                                base.id in globals_declared:
                            self.add(node, "GL003",
                                     "traced value stored in module global "
                                     "%r escapes the trace" % base.id, scope)
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("append", "extend", "add") and \
                    any(taint.expr(a) for a in node.args):
                base = node.func.value
                if isinstance(base, ast.Attribute) and \
                        isinstance(base.value, ast.Name) and \
                        base.value.id == "self":
                    self.add(node, "GL003",
                             "traced value appended to self.%s escapes the "
                             "trace" % base.attr, scope)
            # ---- GL004: data-dependent control flow
            if isinstance(node, (ast.If, ast.While)) and taint.expr(node.test):
                self.add(node, "GL004",
                         "%s on a traced value forces a host sync per step "
                         "(use F.where / lax.cond-style ops)"
                         % ("while" if isinstance(node, ast.While) else "if"),
                         scope)

    # ------------------------------------------------------------- GL002
    def _enclosing_scope(self, node) -> str:
        spans = getattr(self, "_fn_spans", None)
        if spans is None:
            spans = self._fn_spans = [
                (fn.lineno, getattr(fn, "end_lineno", fn.lineno) or fn.lineno,
                 fn.name)
                for fn in ast.walk(self.tree)
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))]
        best = "<module>"
        for start, end, name in spans:
            if start <= node.lineno <= max(start, end):
                best = name  # innermost wins: defs walk outer→inner
        return best

    def _check_percall_jit(self, node: ast.Call):
        """``torch.compile(lambda ...)(x)`` / ``torch.compile(local_fn)(x)``
        invoked inside a function: the compiled callable is new at every
        call, so every call compiles again."""
        inner = node.func
        if not isinstance(inner, ast.Call):
            return
        if _call_name(inner.func) not in _JIT_NAMES or not inner.args:
            return
        target = inner.args[0]
        scope = self._enclosing_scope(node)
        if scope == "<module>":
            return  # a module-level compile builds once a process
        if isinstance(target, ast.Lambda):
            self.add(node, "GL002",
                     "compile(lambda)(…) builds a fresh compiled callable "
                     "per call — every call compiles again; hoist and cache "
                     "it", scope)
        elif isinstance(target, ast.Name) and \
                target.id in self._local_bindings(scope):
            self.add(node, "GL002",
                     "compile(%s)(…) where %r is a per-call local binding "
                     "— a new callable every call compiles again; cache "
                     "the compiled callable" % (target.id, target.id), scope)

    def _check_percall_graph(self, fn):
        """GL002: ``g = torch.cuda.CUDAGraph()`` captured inside ``fn`` and
        never kept (not returned, stored, appended or handed to another
        call than ``torch.cuda.graph(g)``): a capture every call."""
        made = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call) \
                    and _call_name(node.value.func) == "CUDAGraph":
                made[node.targets[0].id] = node
        if not made:
            return
        kept = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and node.value is not None:
                kept.update(n.id for n in ast.walk(node.value)
                            if isinstance(n, ast.Name))
            elif isinstance(node, ast.Assign):
                if not (len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    kept.update(n.id for n in ast.walk(node.value)
                                if isinstance(n, ast.Name))
            elif isinstance(node, ast.Call) and \
                    _call_name(node.func) not in ("graph", "replay"):
                for a in list(node.args) + [k.value for k in node.keywords]:
                    kept.update(n.id for n in ast.walk(a)
                                if isinstance(n, ast.Name))
        for name in sorted(set(made) - kept):
            self.add(made[name], "GL002",
                     "CUDA graph %r is captured and dropped inside one call "
                     "— a capture every call; keep it keyed (a program "
                     "cache) and replay it" % name, fn.name)

    def _local_bindings(self, scope: str) -> Set[str]:
        """Names bound inside function ``scope`` (assignments + nested
        defs) — compiling these per call defeats the compile cache."""
        cached = getattr(self, "_local_bind_cache", None)
        if cached is None:
            cached = self._local_bind_cache = {}
        if scope in cached:
            return cached[scope]
        names: Set[str] = set()
        for fn in ast.walk(self.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                    fn.name == scope:
                for node in ast.walk(fn):
                    if isinstance(node, ast.Name) and \
                            isinstance(node.ctx, ast.Store):
                        names.add(node.id)
                    elif isinstance(node, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)) \
                            and node is not fn:
                        names.add(node.name)
        cached[scope] = names
        return names

    def _check_unordered_key(self, node: ast.Call):
        """tuple(<set>) / list(<set>): set iteration order is not a stable
        cache-key component (varies across processes/hash seeds)."""
        arg = node.args[0]
        is_set = isinstance(arg, ast.Set) or (
            isinstance(arg, ast.Call) and _call_name(arg.func) == "set")
        if is_set:
            self.add(node, "GL002",
                     "%s() over a set has nondeterministic order — sort "
                     "before using it in a cache key or static arg"
                     % _call_name(node.func),
                     self._enclosing_scope(node))

    # ------------------------------------------------------------- GL008
    def _check_unfunneled_jit(self, node: ast.Call):
        """GL008: ``torch.compile(...)``, ``torch.cuda.CUDAGraph()`` or
        ``torch.cuda.graph(...)`` outside ``capture.py``: a program the
        watchdog's counters and ``observability.costs`` never see."""
        path = self.path.replace(os.sep, "/")
        if any(x in path for x in _GL008_EXEMPT):
            return
        f = node.func
        text = ""
        if isinstance(f, ast.Attribute):
            try:
                text = ast.unparse(f)
            except Exception:  # pragma: no cover
                text = f.attr
        if text in ("torch.compile", "torch.cuda.CUDAGraph",
                    "torch.cuda.graph"):
            self.add(node, "GL008",
                     "%s outside capture.py builds a program the build "
                     "counters and the cost ledger do not see — build "
                     "through capture.capture_graph, or allowlist the seam "
                     "with a why" % text, self._enclosing_scope(node))

    # ------------------------------------------------------------- GL009
    def _module_metric_names(self) -> Dict[int, str]:
        """lineno → assigned name for MODULE-LEVEL ``NAME = Cls(...)``
        bindings (allowlist scope stability: the counter's own name, like
        GL006's cache names, survives refactors better than a lineno)."""
        cached = getattr(self, "_gl009_names", None)
        if cached is None:
            cached = self._gl009_names = {}
            for node in self.tree.body:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Call):
                    cached[node.value.lineno] = node.targets[0].id
        return cached

    def _check_adhoc_metric(self, node: ast.Call):
        """GL009: metric state created outside the observability package —
        a ``DispatchCounter(...)`` anywhere, or a module-level metric-class
        binding. Unregistered telemetry is invisible to ``snapshot()``,
        ``/metrics`` and the retrace watchdog."""
        path = self.path.replace(os.sep, "/")
        if any(x in path for x in _GL009_EXEMPT):
            return
        name = _call_name(node.func)
        mod_names = self._module_metric_names()
        if name == "DispatchCounter":
            scope = mod_names.get(node.lineno,
                                  self._enclosing_scope(node))
            self.add(node, "GL009",
                     "DispatchCounter() outside mxnet_tpu_torch/"
                     "observability — "
                     "proof-hook counters live in engine (allowlisted); "
                     "new telemetry goes through observability.registry",
                     scope)
        elif name in _GL009_METRIC_CLASSES and node.lineno in mod_names:
            self.add(node, "GL009",
                     "module-level %s(...) is ad-hoc metric state — create "
                     "it via observability.registry so snapshot()/"
                     "/metrics/the watchdog can see it" % name,
                     mod_names[node.lineno])

    # ------------------------------------------------------------- GL010
    def _check_node_class(self, node: ast.ClassDef):
        """GL010 (classes): a structural graph-node class — an op field
        next to input wiring — defined outside ``mxnet_tpu_torch/ir``. A fourth
        parallel node type re-opens the three-captures problem the
        unified IR closed; new graph machinery composes ``ir.Node`` /
        ``ir.GraphBuilder`` instead. Field evidence: ``__slots__``
        entries, class-level bindings, NamedTuple-style annotations, and
        ``self.X`` assignments in ``__init__``."""
        path = self.path.replace(os.sep, "/")
        if any(x in path for x in _GL010_EXEMPT):
            return
        fields: Set[str] = set()
        for stmt in node.body:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if t.id == "__slots__":
                        try:
                            v = ast.literal_eval(stmt.value)
                        except (ValueError, SyntaxError):
                            v = ()
                        if isinstance(v, (tuple, list)):
                            fields.update(str(x) for x in v)
                    else:
                        fields.add(t.id)
            elif isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                fields.add(stmt.target.id)  # NamedTuple-style field
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name == "__init__":
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Assign):
                        for t in sub.targets:
                            if isinstance(t, ast.Attribute) and \
                                    isinstance(t.value, ast.Name) and \
                                    t.value.id == "self":
                                fields.add(t.attr)
        if fields & _GL010_OP_FIELDS and fields & _GL010_WIRING_FIELDS:
            self.add(node, "GL010",
                     "class %r carries graph-node state (an op field next "
                     "to input wiring) outside mxnet_tpu_torch/ir — structural "
                     "graphs belong in the unified typed IR (ir.Node / "
                     "ir.GraphBuilder); legacy capture shims carry "
                     "allowlist entries" % node.name,
                     node.name)

    def _check_handrolled_key(self, node: ast.Assign):
        """GL010 (keys): ``key = (tuple(...), tuple(...), ...)`` — a
        hand-rolled program-cache key assembled outside ``mxnet_tpu_torch/ir``.
        Cache keys collapsed into the IR's content-addressed canonical
        key; front memos OVER that key are fine but carry allowlist
        entries naming themselves as such."""
        path = self.path.replace(os.sep, "/")
        if any(x in path for x in _GL010_EXEMPT):
            return
        if len(node.targets) != 1 or \
                not isinstance(node.targets[0], ast.Name):
            return
        name = node.targets[0].id
        if "key" not in name.lower() or not isinstance(node.value, ast.Tuple):
            return
        n_calls = sum(1 for e in node.value.elts
                      if isinstance(e, ast.Call)
                      and _call_name(e.func) in _GL010_KEY_CALLS)
        if n_calls >= 2:
            self.add(node, "GL010",
                     "%r hand-rolls a program-cache key (%d tuple/_freeze "
                     "components) — program keys collapse into the IR "
                     "canonical key (ir.canonical_key); front memos over "
                     "it carry allowlist entries" % (name, n_calls),
                     self._enclosing_scope(node))

    # ------------------------------------------------------------- GL007
    @staticmethod
    def _src_key(node: ast.AST) -> str:
        """Structural identity of an expression (x, self.k, cache['k'])
        for matching a rebind target against concat operands."""
        try:
            return ast.unparse(node)
        except Exception:  # pragma: no cover - pre-3.9 fallback
            return ast.dump(node, annotate_fields=False)

    def _check_growing_carried(self, loop):
        """GL007: a loop-carried value rebound to a concat of itself —
        ``x = F.concat(x, new)`` inside for/while. The carried shape grows
        every iteration, so any compiled or captured consumer (including each
        imperative op's cached program) retraces PER STEP — the
        growing-KV-cache decode hazard. numpy calls are exempt: host-side
        result accumulation doesn't feed a trace cache by itself."""
        # names bound by the for-target are re-derived per ELEMENT, not
        # carried across iterations — rebinding them doesn't grow a shape
        loop_vars: Set[str] = set()
        if isinstance(loop, ast.For):
            t = _Taint(set())
            t.assign(loop.target)
            loop_vars = t.names
        for node in ast.walk(loop):
            if not isinstance(node, ast.Assign) or \
                    not isinstance(node.value, ast.Call):
                continue
            call = node.value
            if _call_name(call.func) not in _CONCAT_NAMES:
                continue
            f = call.func
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and f.value.id in _NP_NAMES:
                continue
            operands = []
            for a in call.args:
                if isinstance(a, (ast.List, ast.Tuple)):
                    operands.extend(a.elts)
                elif isinstance(a, ast.Starred):
                    operands.append(a.value)
                else:
                    operands.append(a)
            keys = {self._src_key(a) for a in operands}
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id in loop_vars:
                    continue
                if self._src_key(t) in keys:
                    self.add(node, "GL007",
                             "%r is rebound to a concat of itself inside a "
                             "loop — its shape grows every iteration, so "
                             "compiled consumers retrace per step (use a "
                             "fixed-capacity buffer + cache_write and a "
                             "valid-length mask)" % self._src_key(t),
                             self._enclosing_scope(node))
                    break

    # ------------------------------------------------------------- GL006
    def _check_module_caches(self):
        bounded_markers = ("pop", "popitem", "clear", "move_to_end")
        candidates: Dict[str, ast.AST] = {}
        for node in self.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t, v = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                t, v = node.target, node.value  # NAME: Dict = {}
            else:
                continue
            if not isinstance(t, ast.Name):
                continue
            empty_dict = (isinstance(v, ast.Dict) and not v.keys) or (
                isinstance(v, ast.Call) and _call_name(v.func) == "dict"
                and not v.args and not v.keywords)
            if empty_dict:
                candidates[t.id] = node
        if not candidates:
            return
        grows: Set[str] = set()
        bounded: Set[str] = set()
        for node in ast.walk(self.tree):
            # NAME[key] = ... / NAME.setdefault(...)
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id in candidates:
                        grows.add(t.value.id)
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id in candidates:
                if node.func.attr == "setdefault":
                    grows.add(node.func.value.id)
                if node.func.attr in bounded_markers:
                    bounded.add(node.func.value.id)
            # del NAME[...] or a len(NAME) comparison count as bounding
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and \
                            isinstance(t.value, ast.Name):
                        bounded.add(t.value.id)
            if isinstance(node, ast.Compare):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call) and \
                            _call_name(sub.func) == "len" and sub.args and \
                            isinstance(sub.args[0], ast.Name):
                        bounded.add(sub.args[0].id)
        for name in sorted(grows - bounded):
            node = candidates[name]
            self.add(node, "GL006",
                     "module-level cache %r grows without an eviction path "
                     "(cap it)" % name, name)

    # ------------------------------------------------------------- GL016
    def _check_tuning_tables(self):
        """GL016: a MODULE-LEVEL literal table of block sizes / bucket
        sets — a hand-authored schedule. With ir.tune those
        numbers are search output: tuned tables live in the tuned-config
        store / flash_blocks.json with tuned_by/swept_at provenance, not
        in code. Deliberate cold-start defaults stay allowlisted with a
        why (the allowlist keys on the table's NAME, like GL006/GL009,
        so it survives refactors)."""
        path = self.path.replace(os.sep, "/")
        if any(x in path for x in _GL016_EXEMPT):
            return
        for node in self.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            upper = name.upper()
            if not any(m in upper for m in _GL016_NAME_MARKERS):
                continue
            if not isinstance(node.value, (ast.Dict, ast.List, ast.Tuple,
                                           ast.Set)):
                continue
            n_nums = sum(1 for sub in ast.walk(node.value)
                         if isinstance(sub, ast.Constant)
                         and type(sub.value) in (int, float))
            if n_nums < 2:
                continue
            self.add(node, "GL016",
                     "module-level literal tuning table %r (%d numeric "
                     "constants) — schedules are searched now: emit it "
                     "from ir.tune / the tuned-config store, or allowlist "
                     "the cold-start default with a why" % (name, n_nums),
                     name)

    # ------------------------------------------------------------- GL017
    def _check_process_lifecycle(self):
        """GL017: spawning or signalling OS processes outside the fleet
        layer. Replica lifecycle has one
        owner — FleetRouter spawns serve.worker subprocesses, accounts
        for them, and reaps them; a stray ``subprocess.run``/``os.kill``
        elsewhere creates processes no router tracks (leaked on crash,
        invisible to the kill-9 drill, unreaped zombies). The allowlist
        keys on the ENCLOSING DEF, so a deliberate site (engine's native
        lib build) survives line churn."""
        path = self.path.replace(os.sep, "/")
        if any(x in path for x in _GL017_EXEMPT):
            return

        def visit(node, scope):
            for child in ast.iter_child_nodes(node):
                sub = scope
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    sub = (child.name if scope == "<module>"
                           else "%s.%s" % (scope, child.name))
                if isinstance(child, ast.Call):
                    called = None
                    fn = child.func
                    if isinstance(fn, ast.Attribute) and \
                            isinstance(fn.value, ast.Name):
                        if (fn.value.id == "os"
                                and fn.attr in _GL017_OS_CALLS) or \
                           (fn.value.id == "subprocess"
                                and fn.attr in _GL017_SUBPROCESS_CALLS):
                            called = "%s.%s" % (fn.value.id, fn.attr)
                    elif isinstance(fn, ast.Name) and fn.id == "Popen":
                        called = "Popen"
                    if called is not None:
                        self.add(child, "GL017",
                                 "%s outside the fleet layer — replica "
                                 "lifecycle belongs to serve.fleet/"
                                 "serve.worker (or tools/); allowlist "
                                 "deliberate sites with a why" % called,
                                 scope)
                visit(child, sub)

        visit(self.tree, "<module>")


# ------------------------------------------------------------ entry points


def lint_source(src: str, path: str,
                _conc_shared=None) -> List[Finding]:
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "GL000",
                        "syntax error: %s" % e.msg, "<module>")]
    findings = _ModuleLint(tree, path, src).run()
    # concurrency rules (GL011–GL015). With a shared lint the GL015
    # cross-module lock graph accumulates and finish() runs in the
    # caller; standalone, the cycle check covers just this module.
    conc = _conc_shared if _conc_shared is not None \
        else _conc.ConcurrencyLint()
    lines = src.splitlines()
    findings.extend(Finding(*t) for t in conc.lint_module(tree, path, lines))
    if _conc_shared is None:
        findings.extend(Finding(*t) for t in conc.finish())
    findings.sort(key=lambda x: (x.path, x.line, x.rule, x.msg))
    return findings


class _FileCache:
    """Per-file findings cache keyed by (path, sha256(source)): repeated
    ``lint_paths`` runs in one process (watch loops, the test suite's
    multiple self-lint entry points) skip re-parsing unchanged files.

    An entry stores the file's own findings PLUS the lock-order edge set
    it contributed (linted against a fresh ConcurrencyLint, so the entry
    is independent of what other files ran first); replay merges those
    edges first-wins into the shared lock graph, so the cross-module
    GL015 cycle check still sees every file's edges whether the file was
    linted live or served from cache. Bounded, insertion-order eviction
    (graphlint's own GL006 discipline — this module is stdlib-only, so
    a cache class of the package is out of reach)."""

    def __init__(self, cap: int) -> None:
        self.cap = max(1, int(cap))
        self.hits = 0
        self.misses = 0
        self._store: Dict[Tuple[str, str], Tuple[tuple, dict]] = {}

    def get(self, key):
        entry = self._store.get(key)
        if entry is None:
            self.misses += 1
        else:
            self.hits += 1
        return entry

    def put(self, key, findings, edges) -> None:
        while len(self._store) >= self.cap:
            self._store.pop(next(iter(self._store)))
        self._store[key] = (tuple(findings), dict(edges))

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._store), "cap": self.cap,
                "hits": self.hits, "misses": self.misses}

    def clear(self) -> None:
        self._store.clear()
        self.hits = self.misses = 0


def _cache_cap(default: int = 512) -> int:
    try:
        return int(os.environ.get("MXNET_GRAPHLINT_CACHE_CAP", default))
    except ValueError:
        return default


file_cache = _FileCache(_cache_cap())


def _lint_file(src: str, rel: str, conc) -> List[Finding]:
    """Lint one file through the cache, merging its lock-graph edges
    (first-wins, matching ConcurrencyLint._edge) into the shared graph."""
    key = (rel, hashlib.sha256(src.encode("utf-8")).hexdigest())
    entry = file_cache.get(key)
    if entry is None:
        conc_own = _conc.ConcurrencyLint()
        found = lint_source(src, rel, _conc_shared=conc_own)
        file_cache.put(key, found, conc_own.edges)
        entry = file_cache._store[key]
    found, edges = entry
    for edge, loc in edges.items():
        conc.edges.setdefault(edge, loc)
    return list(found)


def lint_paths(paths, exclude=()) -> List[Finding]:
    """Lint .py files under ``paths`` (files or directories). Paths in
    findings are normalized to forward-slash relatives of the CWD when
    possible, so output and allowlist keys are machine-independent.
    Unchanged files replay from ``file_cache`` (keyed by content hash)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__",) + tuple(exclude))
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    findings: List[Finding] = []
    cwd = os.getcwd()
    conc = _conc.ConcurrencyLint()
    for f in files:
        rel = os.path.relpath(f, cwd)
        rel = f if rel.startswith("..") else rel
        rel = rel.replace(os.sep, "/")
        with open(f, "r", encoding="utf-8") as fh:
            findings.extend(_lint_file(fh.read(), rel, conc))
    findings.extend(Finding(*t) for t in conc.finish())
    findings.sort(key=lambda x: (x.path, x.line, x.rule, x.msg))
    return findings


def load_allowlist(path: str, section: str = "graphlint") -> Dict[str, str]:
    """Committed allowlist: [{"id": "path::rule::scope", "why": "..."}], or
    a dict of such lists by linter (its ``section``). Every entry must
    carry a non-empty ``why`` — the justification lives inline with the
    exemption."""
    with open(path, "r", encoding="utf-8") as fh:
        entries = json.load(fh)
    if isinstance(entries, dict):
        entries = entries.get(section, [])
    out = {}
    for e in entries:
        if not e.get("why", "").strip():
            raise ValueError("allowlist entry %r has no 'why' justification"
                             % e.get("id"))
        out[e["id"]] = e["why"]
    return out


def split_allowed(findings, allow: Dict[str, str]):
    """(kept, suppressed, stale_allow_ids)."""
    kept, suppressed = [], []
    seen = set()
    for f in findings:
        if f.key in allow:
            suppressed.append(f)
            seen.add(f.key)
        else:
            kept.append(f)
    stale = sorted(set(allow) - seen)
    return kept, suppressed, stale


def format_findings(findings) -> str:
    return "\n".join(f.render() for f in findings)


def summarize(findings) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return dict(sorted(out.items()))
