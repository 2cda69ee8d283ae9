"""racecheck: concurrency lint and runtime lock-order and race detection
(counterpart of ``mxnet_tpu/analysis/concurrency.py``, a copy retargeted to
torch).

Two stages, as graphlint and validate, for the port's threading layers
(``serve/batcher``, ``decoder``, ``server``, ``fleet``, ``worker``,
``observability``, ``engine``, ``profiler``, ``gluon/data``). MXNet's
ThreadedEngine made concurrency safety an engine property; the port, like
the JAX package, guards its shared state with ``threading`` locks, so
safety is a checked property:

Stage 1: static rules GL011-GL015, run by graphlint over the package
(pure AST, stdlib only, so a tool can load this module standalone):

* GL011: an unguarded mutation of a shared module-level or instance
  container in a module (or class) that spawns threads;
* GL012: a bare ``lock.acquire()`` with no ``X.release()`` in any
  ``finally`` of the same function (use ``with``);
* GL013: a blocking call while holding a lock: ``torch.cuda.synchronize``,
  ``Event.synchronize`` / ``Stream.synchronize``, ``.item()`` (a host read
  of a device value), sleep, a thread join, a future's ``result``,
  ``open``, a program build (``torch.compile``, ``capture_graph``), a
  queue get/put. ``Condition.wait`` is exempt (it releases);
* GL014: ``Condition.wait`` outside a predicate loop;
* GL015: a cycle in the cross-module static lock-acquisition graph
  (``with A: with B``, plus one level of same-module call resolution).

Stage 2: runtime, opt in with ``MXNET_LOCK_CHECK=1`` (the JAX package's
switch, off by default as there; ``enable_lock_check``):
``InstrumentedLock`` / ``InstrumentedCondition`` record each thread's
acquisition order into one lock-order graph; an edge that closes a cycle
is reported as a potential deadlock with the stack of every edge in it. A
write probe reports overlapping unserialized write sections on registered
shared structures (the batcher queue, the metrics rings, the KV slot
tables, the prefix cache). ``instrument_locks()`` arms the package's
module locks and the live servers (and a server registered later, through
``serve._register``); an error while arming raises.

A stack is captured once per new graph edge and per first race of a
probe, so the steady cost is a thread-local list append and a dict lookup
per held lock.
"""
from __future__ import annotations

import ast
import contextlib
import os
import threading
import traceback

# --------------------------------------------------------------------------
# Stage 1: static rules
# --------------------------------------------------------------------------

RULES = {
    "GL011": "unguarded shared-container mutation in thread-spawning module",
    "GL012": "bare lock.acquire() without with/try-finally release",
    "GL013": "blocking call while holding a lock",
    "GL014": "Condition.wait outside a predicate loop",
    "GL015": "static lock-order cycle in the lock-acquisition graph",
}

_MUT_METHODS = frozenset({
    "append", "appendleft", "add", "update", "setdefault", "extend",
    "insert", "remove", "discard", "clear", "pop", "popitem", "popleft",
    "rotate",
})
_CONTAINER_CALLS = frozenset({
    "dict", "list", "set", "deque", "defaultdict", "OrderedDict",
    "Counter", "BoundedCache", "WeakValueDictionary",
})
_SPAWN_CALLS = frozenset({
    "Thread", "Timer", "ThreadPoolExecutor", "ThreadingHTTPServer",
})
_LOCK_CALLS = {"Lock": "lock", "RLock": "lock", "Condition": "cond"}
_BLOCKING_NAMES = frozenset({"sleep", "synchronize"})
# a program build: torch.compile, a CUDA-graph capture
_COMPILE_NAMES = frozenset({"compile", "capture_graph"})
# a host read of a device value (a sync with the card)
_HOST_READS = frozenset({"item"})
_LOCKISH_TOKENS = ("lock", "cond", "mutex", "guard", "_lk", "sem")


def _call_name(call):
    """Trailing identifier of a call — ``a.b.C(...)`` -> ``C``."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _lockish(text):
    t = text.lower()
    return any(tok in t for tok in _LOCKISH_TOKENS)


def _unparse(node):
    try:
        return ast.unparse(node)
    except Exception:
        return ""


def _disabled_rules(lines, lineno):
    """Inline-suppression parser (same grammar as graphlint's)."""
    if not 1 <= lineno <= len(lines):
        return set()
    line = lines[lineno - 1]
    marker = "graphlint: disable="
    i = line.find(marker)
    if i < 0:
        return set()
    spec = line[i + len(marker):]
    out = set()
    for tok in spec.replace(",", " ").split():
        if tok.startswith("GL") and tok[2:5].isdigit():
            out.add(tok[:5])
        else:
            break
    return out


def _expr_calls(node):
    """Yield Call nodes in an expression/stmt subtree, skipping deferred
    bodies (nested defs, lambdas, comprehension-free: comprehensions DO
    run, so they are not skipped)."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


class _ModuleState:
    def __init__(self, mod, path):
        self.mod = mod
        self.path = path
        self.mod_containers = {}     # name -> lineno
        self.mod_locks = {}          # name -> kind
        self.inst_containers = {}    # cls -> {attr: lineno}
        self.inst_locks = {}         # cls -> {attr: kind}
        self.spawning_classes = set()
        self.module_spawns = False
        self.functions = []          # (FunctionDef, cls-name or None)
        self.fn_locks = {}           # qualname -> set of lock ids
        self.call_sites = []         # (held-tuple, callee qual, lineno)
        self.bare_acquires = []      # (fn-qual, recv-text, lineno)
        self.finally_released = set()  # recv-texts released in a finally
        self.gl011 = {}              # container key -> [(line, msg)]
        self.findings = []           # (path, line, rule, msg, scope)


def _is_container_ctor(v):
    if isinstance(v, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(v, ast.BinOp) and isinstance(v.op, ast.Mult):
        return isinstance(v.left, ast.List) or isinstance(v.right, ast.List)
    if isinstance(v, ast.Call):
        return _call_name(v) in _CONTAINER_CALLS
    return False


def _lock_ctor_kind(v):
    if isinstance(v, ast.Call):
        return _LOCK_CALLS.get(_call_name(v))
    return None


class ConcurrencyLint:
    """Accumulates a cross-module lock graph over lint_module() calls;
    finish() runs the GL015 cycle check over everything seen."""

    def __init__(self):
        self.edges = {}   # (a, b) -> (path, line)

    # ---------------------------------------------------------------- scan
    def lint_module(self, tree, path, src_lines):
        mod = os.path.basename(path)
        if mod.endswith(".py"):
            mod = mod[:-3]
        if mod == "__init__":
            mod = os.path.basename(os.path.dirname(path)) or mod
        st = _ModuleState(mod, path)
        self._collect_defs(tree, st)
        for fn, cls in st.functions:
            _FnVisitor(self, st, fn, cls).run()
        self._resolve_calls(st)
        self._emit_gl011(st, src_lines)
        self._emit_gl012(st, src_lines)
        out = []
        for (p, line, rule, msg, scope) in st.findings:
            if rule not in _disabled_rules(src_lines, line):
                out.append((p, line, rule, msg, scope))
        return out

    def _collect_defs(self, tree, st):
        for s in tree.body:
            if (isinstance(s, ast.Assign) and len(s.targets) == 1
                    and isinstance(s.targets[0], ast.Name)):
                name = s.targets[0].id
                kind = _lock_ctor_kind(s.value)
                if kind:
                    st.mod_locks[name] = kind
                elif _is_container_ctor(s.value):
                    st.mod_containers[name] = s.lineno
        owner = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                spawns = False
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call) \
                            and _call_name(sub) in _SPAWN_CALLS:
                        spawns = True
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        owner[sub] = node.name
                        if sub.name == "__init__":
                            self._collect_init(sub, node.name, st)
                if spawns:
                    st.spawning_classes.add(node.name)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and _call_name(node) in _SPAWN_CALLS:
                st.module_spawns = True
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                st.functions.append((node, owner.get(node)))

    def _collect_init(self, init, cls, st):
        for s in ast.walk(init):
            if not (isinstance(s, ast.Assign) and len(s.targets) == 1):
                continue
            t = s.targets[0]
            if not (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                continue
            kind = _lock_ctor_kind(s.value)
            if kind:
                st.inst_locks.setdefault(cls, {})[t.attr] = kind
            elif _is_container_ctor(s.value):
                st.inst_containers.setdefault(cls, {})[t.attr] = s.lineno

    # ------------------------------------------------------------- resolve
    def _edge(self, a, b, path, line):
        if a != b and (a, b) not in self.edges:
            self.edges[(a, b)] = (path, line)

    def _resolve_calls(self, st):
        for held, callee, line in st.call_sites:
            for lid in st.fn_locks.get(callee, ()):
                for h in held:
                    self._edge(h, lid, st.path, line)

    def _emit_gl011(self, st, src_lines):
        for key in sorted(st.gl011):
            sites = [(line, msg) for line, msg in st.gl011[key]
                     if "GL011" not in _disabled_rules(src_lines, line)]
            if sites:
                line, msg = min(sites)
                st.findings.append((st.path, line, "GL011", msg, key))

    def _emit_gl012(self, st, src_lines):
        for fq, recv, line in st.bare_acquires:
            if recv in st.finally_released:
                continue
            st.findings.append((
                st.path, line, "GL012",
                "bare %s.acquire() with no release in a finally — use "
                "'with %s:' so errors cannot leak the lock" % (recv, recv),
                fq))

    # -------------------------------------------------------------- finish
    def finish(self):
        adj = {}
        for (a, b) in self.edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        findings = []
        for scc in _tarjan(adj):
            if len(scc) < 2:
                continue
            nodes = sorted(scc)
            sig = "->".join(nodes)
            inside = set(scc)
            cands = sorted(
                (p, ln) for (a, b), (p, ln) in self.edges.items()
                if a in inside and b in inside)
            path, line = cands[-1]
            cyc = _cycle_path(adj, inside, nodes[0])
            findings.append((
                path, line, "GL015",
                "lock-order cycle: %s — threads taking these locks in "
                "different orders can deadlock; pick one global order"
                % " -> ".join(cyc), sig))
        return findings


def _tarjan(adj):
    """Strongly connected components (iterative), deterministic order."""
    index = {}
    low = {}
    on = set()
    stack = []
    sccs = []
    counter = [0]

    def strongconnect(root):
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                elif w in on:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                sccs.append(scc)

    for n in sorted(adj):
        if n not in index:
            strongconnect(n)
    return sccs


def _cycle_path(adj, inside, start):
    """A concrete cycle through `start` restricted to one SCC."""
    path = [start]
    seen = {start}
    cur = start
    while True:
        nxts = [w for w in sorted(adj.get(cur, ())) if w in inside]
        if not nxts:
            return path + [start]
        nxt = next((w for w in nxts if w == start), None)
        if nxt is not None and len(path) > 1:
            return path + [start]
        nxt = next((w for w in nxts if w not in seen), nxts[0])
        if nxt in seen:
            return path + [start]
        path.append(nxt)
        seen.add(nxt)
        cur = nxt


class _FnVisitor:
    def __init__(self, lint, st, fn, cls):
        self.lint = lint
        self.st = st
        self.fn = fn
        self.cls = cls
        self.fq = "%s.%s" % (cls, fn.name) if cls else fn.name

    def run(self):
        self._stmts(self.fn.body, [], 0)

    # ---------------------------------------------------------- traversal
    def _stmts(self, body, held, loop):
        for s in body:
            self._stmt(s, held, loop)

    def _stmt(self, s, held, loop):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            cur = list(held)
            for item in s.items:
                for c in _expr_calls(item.context_expr):
                    self._call(c, cur, loop)
                lid, pseudo = self._lock_id(item.context_expr)
                if lid:
                    for h in cur:
                        if not h.startswith("~"):
                            self.lint._edge(h, lid, self.st.path, s.lineno)
                    for key in self._fn_keys():
                        self.st.fn_locks.setdefault(key, set()).add(lid)
                    cur.append(lid)
                elif pseudo:
                    cur.append("~" + pseudo)
            self._stmts(s.body, cur, loop)
        elif isinstance(s, (ast.For, ast.AsyncFor)):
            for c in _expr_calls(s.iter):
                self._call(c, held, loop)
            self._stmts(s.body, held, loop + 1)
            self._stmts(s.orelse, held, loop)
        elif isinstance(s, ast.While):
            for c in _expr_calls(s.test):
                self._call(c, held, loop)
            self._stmts(s.body, held, loop + 1)
            self._stmts(s.orelse, held, loop)
        elif isinstance(s, ast.If):
            for c in _expr_calls(s.test):
                self._call(c, held, loop)
            self._stmts(s.body, held, loop)
            self._stmts(s.orelse, held, loop)
        elif isinstance(s, ast.Try):
            self._stmts(s.body, held, loop)
            for h in s.handlers:
                self._stmts(h.body, held, loop)
            self._stmts(s.orelse, held, loop)
            self._stmts(s.finalbody, held, loop)
            for sub in s.finalbody:
                for c in _expr_calls(sub):
                    if isinstance(c.func, ast.Attribute) \
                            and c.func.attr == "release":
                        self.st.finally_released.add(_unparse(c.func.value))
        else:
            self._simple(s, held, loop)

    # ------------------------------------------------------------- checks
    def _simple(self, s, held, loop):
        for c in _expr_calls(s):
            self._call(c, held, loop)
            if isinstance(s, ast.Expr) and s.value is c \
                    and isinstance(c.func, ast.Attribute) \
                    and c.func.attr == "acquire":
                self.st.bare_acquires.append(
                    (self.fq, _unparse(c.func.value), c.lineno))
        if isinstance(s, ast.Assign):
            for t in s.targets:
                self._target(t, held, rebind=True)
        elif isinstance(s, ast.AugAssign):
            self._target(s.target, held, rebind=False)
        elif isinstance(s, ast.Delete):
            for t in s.targets:
                self._target(t, held, rebind=False)

    def _call(self, c, held, loop):
        name = _call_name(c)
        attr = c.func.attr if isinstance(c.func, ast.Attribute) else None
        recv = _unparse(c.func.value) if attr else ""
        # GL014 — Condition.wait outside a predicate loop
        if attr == "wait" and loop == 0 and self._is_cond(c.func.value, recv):
            self.st.findings.append((
                self.st.path, c.lineno, "GL014",
                "%s.wait() outside a while-predicate loop — spurious "
                "wakeups and missed notifies require re-checking the "
                "condition in a loop" % recv, self.fq))
        # GL013 — blocking while holding a lock (Condition.wait exempt:
        # it releases the lock while blocked)
        if held and attr != "wait":
            blocked = self._blocking_reason(c, name, attr, recv)
            if blocked:
                lock = next((h for h in reversed(held)
                             if not h.startswith("~")), held[-1].lstrip("~"))
                self.st.findings.append((
                    self.st.path, c.lineno, "GL013",
                    "%s while holding %s — move the blocking work outside "
                    "the critical section" % (blocked, lock), self.fq))
        # GL011 — mutating method on a tracked shared container
        if attr in _MUT_METHODS:
            key = self._container_key(c.func.value)
            if key and not held:
                self.st.gl011.setdefault(key, []).append((
                    c.lineno,
                    "unguarded %s.%s() on shared container %s in a "
                    "thread-spawning module — guard with a lock or "
                    "allowlist the single-writer invariant"
                    % (recv, attr, key)))
        # GL015 — one-level same-module call resolution
        real = tuple(h for h in held if not h.startswith("~"))
        if real:
            callee = None
            if isinstance(c.func, ast.Name):
                callee = c.func.id
            elif attr and isinstance(c.func.value, ast.Name) \
                    and c.func.value.id == "self" and self.cls:
                callee = "%s.%s" % (self.cls, attr)
            if callee:
                self.st.call_sites.append((real, callee, c.lineno))

    def _blocking_reason(self, c, name, attr, recv):
        if name in _BLOCKING_NAMES:
            return "%s()" % (("%s.%s" % (recv, name)) if recv else name)
        if name in _COMPILE_NAMES and (recv in ("", "torch")
                                       or name == "capture_graph"):
            return "program build %s()" % name
        if attr in _HOST_READS and not c.args:
            return "host read %s.%s()" % (recv, attr)
        if isinstance(c.func, ast.Name) and name == "open":
            return "file open()"
        if attr == "result":
            return "future %s.result()" % recv
        if attr == "join" and self._join_blocks(c):
            return "%s.join()" % recv
        if attr in ("get", "put") and self._queueish(recv):
            return "queue %s.%s()" % (recv, attr)
        return None

    @staticmethod
    def _join_blocks(c):
        # thread/process join: no args, a timeout kwarg, or a numeric
        # first arg — excludes str.join(iterable)
        if not c.args and not c.keywords:
            return True
        if any(k.arg == "timeout" for k in c.keywords):
            return True
        return bool(c.args) and isinstance(c.args[0], ast.Constant) \
            and isinstance(c.args[0].value, (int, float))

    @staticmethod
    def _queueish(recv):
        r = recv.lower()
        tail = r.rsplit(".", 1)[-1]
        return "queue" in r or tail == "q" or tail.endswith("_q")

    def _is_cond(self, value, recv):
        if isinstance(value, ast.Name):
            kind = self.st.mod_locks.get(value.id)
            if kind:
                return kind == "cond"
        if isinstance(value, ast.Attribute) \
                and isinstance(value.value, ast.Name) \
                and value.value.id == "self" and self.cls:
            kind = self.st.inst_locks.get(self.cls, {}).get(value.attr)
            if kind:
                return kind == "cond"
        return "cond" in recv.lower()

    def _fn_keys(self):
        if self.cls:
            return ("%s.%s" % (self.cls, self.fn.name),)
        return (self.fn.name,)

    def _lock_id(self, expr):
        """(canonical lock id | None, lockish-text pseudo | None)."""
        if isinstance(expr, ast.Name):
            if expr.id in self.st.mod_locks:
                return "%s.%s" % (self.st.mod, expr.id), None
            if _lockish(expr.id):
                return None, expr.id
        if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                         ast.Name):
            base = expr.value.id
            if base == "self" and self.cls:
                if expr.attr in self.st.inst_locks.get(self.cls, {}):
                    return "%s.%s.%s" % (self.st.mod, self.cls,
                                         expr.attr), None
                if _lockish(expr.attr):
                    return None, "self." + expr.attr
            elif _lockish(expr.attr):
                # module-attribute reference: other_mod._lock
                return "%s.%s" % (base, expr.attr), None
        text = _unparse(expr)
        if text and _lockish(text):
            return None, text
        return None, None

    def _container_key(self, expr):
        if isinstance(expr, ast.Name):
            if expr.id in self.st.mod_containers and self.st.module_spawns:
                return "%s.%s" % (self.st.mod, expr.id)
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and self.cls \
                and self.fn.name != "__init__" \
                and expr.attr in self.st.inst_containers.get(self.cls, {}) \
                and (self.cls in self.st.spawning_classes
                     or self.st.module_spawns):
            return "%s.%s" % (self.cls, expr.attr)
        return None

    def _target(self, t, held, rebind):
        if isinstance(t, ast.Tuple):
            for e in t.elts:
                self._target(e, held, rebind)
            return
        key = None
        line = t.lineno
        what = None
        if isinstance(t, ast.Subscript):
            key = self._container_key(t.value)
            what = "%s[...] store" % _unparse(t.value)
        elif rebind and isinstance(t, ast.Attribute):
            key = self._container_key(t)
            what = "rebind of %s" % _unparse(t)
        if key and not held:
            self.st.gl011.setdefault(key, []).append((
                line,
                "unguarded %s on shared container %s in a thread-spawning "
                "module — guard with a lock or allowlist the single-writer "
                "invariant" % (what, key)))


# --------------------------------------------------------------------------
# Stage 2: runtime lock-order + race detection (opt-in)
# --------------------------------------------------------------------------

_MAX_EDGES = 4096
_MAX_REPORTS = 32

_enabled = os.environ.get("MXNET_LOCK_CHECK", "") in ("1", "true", "on")
_guard = threading.Lock()          # protects the graph + report buffers
_tls = threading.local()
_edges_rt = {}                     # (a, b) -> {"thread", "stack"}
_edges_dropped = 0
_cycles = []                       # bounded deadlock reports
_cycle_sigs = set()
# probe registries: keyed by the fixed set of instrumented structure
# names (a dozen-odd), not by request-scoped data — bounded by design
_probes = {}      # name -> _Probe  # graphlint: disable=GL006
_watched = {}     # name -> strong ref  # graphlint: disable=GL006
_watch_ids = {}   # id(obj) -> _Probe  # graphlint: disable=GL006
_race_reports = []
_instrumented = set()              # descriptive names, for idempotency


def enable_lock_check(on=True):
    """Arm/disarm the runtime stage; returns the previous state. The
    wrappers installed by instrument_locks() stay in place but reduce to
    a single boolean check when disarmed."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    return prev


def lock_check_enabled():
    return _enabled


def reset_runtime():
    """Clear accumulated graph/reports (hermetic tests)."""
    global _edges_dropped
    with _guard:
        _edges_rt.clear()
        _cycles.clear()
        _cycle_sigs.clear()
        _race_reports.clear()
        _edges_dropped = 0
        for p in _probes.values():
            p.owner = None
            p.depth = 0
            p.races = 0


def _held():
    try:
        return _tls.held
    except AttributeError:
        _tls.held = []
        return _tls.held


def _note_acquire(name):
    held = _held()
    for h in held:
        if h != name and (h, name) not in _edges_rt:
            _record_edge(h, name)
    held.append(name)


def _note_release(name):
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


def _stack():
    return "".join(traceback.format_stack(limit=16)[:-3])


def _record_edge(a, b):
    global _edges_dropped
    stack = _stack()
    with _guard:
        if (a, b) in _edges_rt:
            return
        if len(_edges_rt) >= _MAX_EDGES:
            _edges_dropped += 1
            return
        _edges_rt[(a, b)] = {"thread": threading.current_thread().name,
                             "stack": stack}
        _check_cycle_locked(a, b)


def _check_cycle_locked(a, b):
    if len(_cycles) >= _MAX_REPORTS:
        return
    adj = {}
    for (x, y) in _edges_rt:
        adj.setdefault(x, []).append(y)
    path = _dfs_path(adj, b, a)
    if path is None:
        return
    cycle = [a] + path
    sig = "->".join(sorted(set(cycle)))
    if sig in _cycle_sigs:
        return
    _cycle_sigs.add(sig)
    stacks = {}
    for i in range(len(cycle) - 1):
        e = _edges_rt.get((cycle[i], cycle[i + 1]))
        if e:
            stacks["%s->%s" % (cycle[i], cycle[i + 1])] = dict(e)
    _cycles.append({"cycle": cycle, "edges": stacks})


def _dfs_path(adj, src, dst):
    """Node path src..dst, or None."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for w in adj.get(node, ()):
            if w not in seen:
                seen.add(w)
                stack.append((w, path + [w]))
    return None


class InstrumentedLock:
    """Drop-in threading.Lock wrapper that records per-thread lock
    acquisition order into the global lock-order graph."""

    def __init__(self, name, inner=None):
        self._name = name
        self._inner = inner if inner is not None else threading.Lock()

    def acquire(self, blocking=True, timeout=-1):
        ok = self._inner.acquire(blocking, timeout)
        if ok and _enabled:
            _note_acquire(self._name)
        return ok

    def release(self):
        if _enabled:
            _note_release(self._name)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()  # graphlint: disable=GL012 — released in __exit__
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class InstrumentedCondition:
    """threading.Condition wrapper; wait() is modelled as release +
    re-acquire so lock-order edges stay truthful across the block."""

    def __init__(self, name, inner=None):
        self._name = name
        self._inner = inner if inner is not None else threading.Condition()

    def acquire(self, *a, **k):
        ok = self._inner.acquire(*a, **k)
        if ok and _enabled:
            _note_acquire(self._name)
        return ok

    def release(self):
        if _enabled:
            _note_release(self._name)
        self._inner.release()

    def __enter__(self):
        self._inner.__enter__()
        if _enabled:
            _note_acquire(self._name)
        return self

    def __exit__(self, *exc):
        if _enabled:
            _note_release(self._name)
        return self._inner.__exit__(*exc)

    def wait(self, timeout=None):
        if _enabled:
            _note_release(self._name)
        try:
            return self._inner.wait(timeout)
        finally:
            if _enabled:
                _note_acquire(self._name)

    def wait_for(self, predicate, timeout=None):
        if _enabled:
            _note_release(self._name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            if _enabled:
                _note_acquire(self._name)

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()


# ------------------------------------------------------------- race probes

class _Probe:
    __slots__ = ("name", "owner", "depth", "sample", "k", "races")

    def __init__(self, name, sample):
        self.name = name
        self.owner = None
        self.depth = 0
        self.sample = max(1, int(sample))
        self.k = 0
        self.races = 0


def register_shared(name, obj=None, sample=None):
    """Register a shared structure for write-overlap detection. If `obj`
    is given, a strong ref is kept so patched mutators (BoundedCache)
    can find their probe by id()."""
    if sample is None:
        sample = int(os.environ.get("MXNET_RACE_SAMPLE", "1") or 1)
    p = _probes.get(name)
    if p is None:
        p = _probes[name] = _Probe(name, sample)
    if obj is not None:
        _watched[name] = obj
        _watch_ids[id(obj)] = p
    return p


def _probe_enter(p):
    if not _enabled:
        return False
    p.k += 1
    if p.sample > 1 and (p.k % p.sample):
        return False
    me = threading.get_ident()
    owner = p.owner
    if owner is not None and owner != me:
        _report_race(p, owner, me)
    p.owner = me
    p.depth += 1
    return True


def _probe_exit(p, tok):
    if not tok:
        return
    p.depth -= 1
    if p.depth <= 0:
        p.depth = 0
        p.owner = None


def _report_race(p, owner, me):
    p.races += 1
    if p.races > 1:
        return
    stack = _stack()
    with _guard:
        if len(_race_reports) >= _MAX_REPORTS:
            return
        _race_reports.append({
            "shared": p.name,
            "threads": sorted([owner, me]),
            "thread_name": threading.current_thread().name,
            "stack": stack,
        })


@contextlib.contextmanager
def shared_write(name):
    """Mark a write section on a registered shared structure. Overlapping
    sections from two threads are reported as a data race."""
    p = _probes.get(name)
    if p is None or not _enabled:
        yield
        return
    tok = _probe_enter(p)
    try:
        yield
    finally:
        _probe_exit(p, tok)


class _WatchedList(list):
    """List whose mutators run under a race probe (slot tables, rings)."""

    def __init__(self, items, probe):
        list.__init__(self, items)
        self._probe = probe

    def _mut(self, op, *a):
        tok = _probe_enter(self._probe)
        try:
            return op(self, *a)
        finally:
            _probe_exit(self._probe, tok)

    def __setitem__(self, i, v):
        return self._mut(list.__setitem__, i, v)

    def append(self, v):
        return self._mut(list.append, v)

    def pop(self, i=-1):
        return self._mut(list.pop, i)

    def remove(self, v):
        return self._mut(list.remove, v)

    def extend(self, it):
        return self._mut(list.extend, it)

    def insert(self, i, v):
        return self._mut(list.insert, i, v)

    def clear(self):
        return self._mut(list.clear)


import collections as _collections  # noqa: E402


class _WatchedDeque(_collections.deque):
    """Deque whose mutators run under a race probe (batcher queue)."""

    def __init__(self, items, probe):
        _collections.deque.__init__(self, items)
        self._probe = probe

    def _mut(self, op, *a):
        tok = _probe_enter(self._probe)
        try:
            return op(self, *a)
        finally:
            _probe_exit(self._probe, tok)

    def append(self, v):
        return self._mut(_collections.deque.append, v)

    def appendleft(self, v):
        return self._mut(_collections.deque.appendleft, v)

    def pop(self):
        return self._mut(_collections.deque.pop)

    def popleft(self):
        return self._mut(_collections.deque.popleft)

    def remove(self, v):
        return self._mut(_collections.deque.remove, v)

    def extend(self, it):
        return self._mut(_collections.deque.extend, it)

    def clear(self):
        return self._mut(_collections.deque.clear)

    def rotate(self, n=1):
        return self._mut(_collections.deque.rotate, n)


# -------------------------------------------------------- instrumentation

def _wrap_module_lock(mod, attr, name):
    cur = getattr(mod, attr)
    if isinstance(cur, (InstrumentedLock, InstrumentedCondition)):
        return False
    setattr(mod, attr, InstrumentedLock(name, inner=cur))
    return True


def _wrap_attr_lock(obj, attr, name):
    cur = getattr(obj, attr)
    if isinstance(cur, (InstrumentedLock, InstrumentedCondition)):
        return False
    setattr(obj, attr, InstrumentedLock(name, inner=cur))
    return True


def instrument_locks():
    """Arm the package's module locks and every live server (a server
    registered later is armed at ``serve._register``). Idempotent; returns
    the number of newly instrumented targets. An error raises: a check
    that cannot arm must not look like a clean run."""
    from .. import profiler as _prof
    from .. import serve as _serve
    from ..ir import lower as _irlower
    from ..ir import tune as _tune
    from ..observability import costs as _costs
    from ..observability import registry as _registry
    from ..observability import watchdog as _watchdog

    n = 0
    n += _wrap_module_lock(_prof, "_lock", "profiler._lock")
    n += _wrap_module_lock(_watchdog, "_lock", "watchdog._lock")
    n += _wrap_module_lock(_costs, "_lock", "costs._lock")
    n += _wrap_module_lock(_irlower, "_lock", "ir.lower._lock")
    n += _wrap_module_lock(_irlower, "_run_lock", "ir.lower._run_lock")
    n += _wrap_module_lock(_tune, "_lock", "ir.tune._lock")
    n += _wrap_attr_lock(_registry, "_lock", "MetricsRegistry._lock")
    for srv in list(_serve._SERVERS):
        n += instrument_server(srv)
    _instrumented.add("modules")
    return n


def instrument_server(server):
    """Arm one live ModelServer or GenerativeServer: the batcher's
    condition and queue, the metrics lock and latency ring, the dispatch,
    replica and parameter locks, the decode join condition, the KV slot
    tables and the prefix cache. Call before ``start()`` for full
    coverage."""
    key = "server@%x" % id(server)
    if key in _instrumented:
        return 0
    _instrumented.add(key)
    n = 0
    b = server._batcher
    if not isinstance(b._cond, InstrumentedCondition):
        b._cond = InstrumentedCondition("DynamicBatcher._cond",
                                        inner=b._cond)
        n += 1
    if not isinstance(b._queue, _WatchedDeque):
        b._queue = _WatchedDeque(b._queue,
                                 register_shared("serve.batcher_queue"))
        n += 1
    m = server.metrics
    n += _wrap_attr_lock(m, "_lock", "ServeMetrics._lock")
    if not isinstance(m._lat, _WatchedList):
        m._lat = _WatchedList(m._lat, register_shared("serve.metrics_rings"))
        n += 1
    if hasattr(server, "_batch_lock"):
        n += _wrap_attr_lock(server, "_batch_lock",
                             "ModelServer._batch_lock")
    if hasattr(server, "_replica_locks"):
        locks = server._replica_locks
        for i, lk in enumerate(locks):
            if not isinstance(lk, InstrumentedLock):
                locks[i] = InstrumentedLock(
                    "ModelServer._replica_locks[%d]" % i, inner=lk)
                n += 1
        server._params_lock = locks[0]
    elif hasattr(server, "_params_lock"):
        n += _wrap_attr_lock(server, "_params_lock",
                             "GenerativeServer._params_lock")
    if hasattr(server, "_join_cond") and \
            not isinstance(server._join_cond, InstrumentedCondition):
        server._join_cond = InstrumentedCondition(
            "GenerativeServer._join_cond", inner=server._join_cond)
        n += 1
    cache = getattr(server, "cache", None)
    if cache is not None and not isinstance(cache._free, _WatchedList):
        p = register_shared("serve.kv_slots")
        cache._free = _WatchedList(cache._free, p)
        cache._owner = _WatchedList(cache._owner, p)
        n += 1
    for attr in ("_slot_req", "_remaining"):
        tbl = getattr(server, attr, None)
        if isinstance(tbl, list) and not isinstance(tbl, _WatchedList):
            setattr(server, attr, _WatchedList(
                tbl, register_shared("serve.slot_tables")))
            n += 1
    prefix = getattr(server, "prefix", None)
    if prefix is not None:
        register_shared("serve.prefix_cache", prefix._store)
        n += _wrap_attr_lock(prefix._store, "_lock",
                             "PrefixCache._store._lock")
    return n


# ---------------------------------------------------------------- reports

def runtime_stats(verbose=False):
    """Snapshot of the runtime stage: lock-order graph size, deadlock
    cycles, race reports. verbose=True includes per-edge stacks."""
    with _guard:
        nodes = set()
        for a, b in _edges_rt:
            nodes.add(a)
            nodes.add(b)
        if verbose:
            cycles = [dict(c) for c in _cycles]
            races = [dict(r) for r in _race_reports]
        else:
            cycles = [{"cycle": list(c["cycle"])} for c in _cycles]
            races = [{"shared": r["shared"], "threads": list(r["threads"])}
                     for r in _race_reports]
        return {
            "enabled": _enabled,
            "graph_nodes": len(nodes),
            "graph_edges": len(_edges_rt),
            "edges_dropped": _edges_dropped,
            "cycles": cycles,
            "races": races,
            "race_hits": {p.name: p.races for p in _probes.values()
                          if p.races},
            "watched": sorted(_probes),
        }
