"""serve.fleet — multi-process replica fleet: least-loaded routing, SLO
autoscaling, zero-downtime weight hot-swap (counterpart of
``mxnet_tpu/serve/fleet.py``; ref: mxnet-model-server's frontend/worker
split — its Netty router, ``scale-worker`` management API and per-model
worker pools — rebuilt over serve.worker subprocesses).

In the port several workers may share one CUDA card, each process with its
own context, weights and CUDA graphs. The kernels are built once into the
package's ``_build/`` before workers spawn (a worker builds nothing), and
a worker is killed only after its ready line. ``predict`` returns CPU
tensors in the served dtypes (``util.loads_npz_exact``).

Topology: each replica is ONE subprocess (``python -m mxnet_tpu_torch.serve.worker``)
wrapping a snapshot-warm ModelServer/GenerativeServer; the router is a
library in the caller's process. A worker's single HTTP port carries data
(``/predict``, ``/generate``), control (``/swap``, ``/drain``, prefix
migration) and observability (``/metrics``, ``/health``).

Routing: least-loaded by the two ``/health`` gauges — ``queue_depth +
tokens_in_flight`` — with a round-robin tiebreak, skipping draining
replicas. Generative sessions get prefix-cache-aware affinity: a
``session=`` id sticks to one worker so multi-turn prompts hit its
PrefixCache; on planned retirement the dying worker's prefix entries are
exported and injected into the inheriting sibling, so the sessions keep
their KV pages (PagedKVCache extract/inject, host-side npz in between).

Failure: a connection-level error (refused / reset / half-written reply)
is ``WorkerGone`` — the router removes the replica and retries the request
on a sibling. ``kill -9`` mid-wave therefore costs only that worker's
in-flight work, and even those requests are retried (predict and
fixed-seed generate are idempotent), so a wave completes with zero
failures. 503 (busy/draining) retries siblings too; 504 and model errors
propagate typed.

Autoscaling: ``Autoscaler`` samples worker stats on an interval; sustained
SLO pressure (p95 latency over target, or shedding above ``shed_rate``)
spawns a snapshot-warm replica (every program captured before its first
request, watchdog armed); sustained idle drains-then-retires down to
``min_workers``.

Hot swap: ``hot_swap()`` pushes a checkpoint (raw npz bytes) to every
replica; each validates structurally against its live ParameterDict
*before* touching a weight and flips atomically under the params seam
BucketedExecutor reads per dispatch — a mid-swap dispatch sees all-old or
all-new, never a mix, and a rejected push (missing/extra/reshaped/requantized
params) leaves the old weights serving everywhere.
"""
from __future__ import annotations

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque

import numpy as np

from ..checkpoint import SwapError
from ..util import dumps_npz_exact, loads_npz_exact
from .batcher import ServeError, ServerBusy, ServeTimeout

__all__ = ["WorkerGone", "WorkerSpec", "WorkerHandle", "FleetRouter",
           "Autoscaler"]

_STATUS_ERRORS = {503: ServerBusy, 504: ServeTimeout, 409: SwapError}


class WorkerGone(ServeError):
    """The replica's process or connection is gone (refused, reset, died
    mid-reply). Routers treat this as 'remove and retry a sibling' —
    never as a request failure."""


class WorkerSpec:
    """How to (re)spawn a replica — the unit the autoscaler clones.

    ``snapshot``: serving snapshot prefix (the production path — the
    spawned process captures every listed program before its first
    request; ``kwargs`` carries its device). ``factory``: ``module:fn`` / ``file.py:fn`` returning a ready
    server (the dryrun/test path). ``model``: factory for the decode model
    when the snapshot is generative. ``kwargs``: JSON-able constructor
    overrides for the snapshot path. ``env``: extra environment for the
    subprocess (inherits the parent's otherwise)."""

    def __init__(self, factory=None, snapshot=None, model=None, kwargs=None,
                 env=None):
        if (snapshot is None) == (factory is None):
            raise ValueError("exactly one of snapshot= / factory=")
        self.factory = factory
        self.snapshot = snapshot
        self.model = model
        self.kwargs = dict(kwargs or {})
        self.env = dict(env or {})

    def argv(self, port=0):
        argv = [sys.executable, "-m", "mxnet_tpu_torch.serve.worker",
                "--port", str(int(port))]
        if self.factory is not None:
            argv += ["--factory", self.factory]
        else:
            argv += ["--snapshot", self.snapshot]
            if self.kwargs:
                argv += ["--kwargs", json.dumps(self.kwargs)]
        if self.model is not None:
            argv += ["--model", self.model]
        return argv


class WorkerHandle:
    """Client for one replica: typed HTTP calls + process lifecycle.

    Connections are per-thread with keep-alive (HTTP/1.1) — routing a
    request costs one round-trip on a warm socket, not a handshake. Every
    connection-level failure closes the socket and raises WorkerGone."""

    def __init__(self, host, port, proc=None, spec=None, kind="model",
                 name=None):
        self.host = host
        self.port = int(port)
        self.proc = proc
        self.spec = spec
        self.kind = kind
        # port-qualified: replicas of one model share the server name, and
        # hot_swap/stats key rows by handle name — collisions would merge
        self.name = "%s@%d" % (name or "worker", self.port)
        self.pid = proc.pid if proc is not None else None
        self._local = threading.local()

    # ------------------------------------------------------------- spawn
    @classmethod
    def spawn(cls, spec, port=0, timeout_s=180.0, debug=None):
        """Launch ``python -m mxnet_tpu_torch.serve.worker`` and block until its
        READY line (JSON on stdout) reports the bound port. The child
        inherits the parent's environment plus
        ``spec.env`` overrides."""
        env = dict(os.environ)
        env.update(spec.env)
        if debug is None:
            debug = bool(env.get("MXTPU_FLEET_DEBUG"))
        proc = subprocess.Popen(
            spec.argv(port), stdout=subprocess.PIPE,
            stderr=None if debug else subprocess.DEVNULL,
            env=env, text=True)
        deadline = time.perf_counter() + timeout_s
        line = ""
        while time.perf_counter() < deadline:
            line = proc.stdout.readline()
            if not line:
                if proc.poll() is not None:
                    raise WorkerGone(
                        "worker exited rc=%s before READY (argv=%r%s)"
                        % (proc.returncode, spec.argv(port),
                           "" if debug else
                           "; rerun with MXTPU_FLEET_DEBUG=1 for stderr"))
                time.sleep(0.01)
                continue
            line = line.strip()
            if line.startswith("{"):
                break
        else:
            proc.kill()
            raise WorkerGone("worker not READY within %.0fs" % timeout_s)
        ready = json.loads(line)
        return cls("127.0.0.1", ready["port"], proc=proc, spec=spec,
                   kind=ready.get("kind", "model"), name=ready.get("name"))

    # ------------------------------------------------------------- client
    def _conn(self, timeout):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=timeout)
            self._local.conn = conn
        else:
            conn.timeout = timeout
        return conn

    def _drop_conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            try:
                conn.close()
            except Exception:
                pass

    def request(self, method, path, body=None, timeout=30.0):
        """One round-trip; returns (status, body bytes). Connection-level
        failures → WorkerGone (one silent retry on a fresh socket first:
        a keep-alive peer may have closed the idle connection under us)."""
        for attempt in (0, 1):
            conn = self._conn(timeout)
            try:
                conn.request(method, path, body=body)
                resp = conn.getresponse()
                return resp.status, resp.read()
            except (ConnectionError, http.client.HTTPException,
                    TimeoutError, OSError) as e:
                self._drop_conn()
                if attempt and not self.alive():
                    raise WorkerGone("worker %s: %s" % (self.name, e)) from e
                if attempt:
                    raise WorkerGone(
                        "worker %s unreachable: %s" % (self.name, e)) from e

    def _checked(self, method, path, body=None, timeout=30.0):
        status, data = self.request(method, path, body=body, timeout=timeout)
        if status == 200:
            return data
        try:
            payload = json.loads(data.decode("utf-8"))
        except Exception:
            payload = {"message": data[:200].decode("utf-8", "replace")}
        err = _STATUS_ERRORS.get(status, ServeError)
        raise err("%s %s -> %d: %s" % (method, path, status,
                                       payload.get("message", payload)))

    # ---------------------------------------------------------- endpoints
    def health(self, timeout=5.0):
        return json.loads(self._checked("GET", "/health", timeout=timeout))

    def server_stats(self, timeout=10.0):
        return json.loads(self._checked("GET", "/server_stats",
                                        timeout=timeout))

    def load_score(self):
        """queue_depth + tokens_in_flight, or None when unhealthy/draining
        (the router skips those)."""
        try:
            h = self.health()
        except (WorkerGone, ServeError):
            return None
        if not h.get("ok", True) or h.get("draining"):
            return None
        return int(h.get("queue_depth") or 0) + \
            int(h.get("tokens_in_flight") or 0)

    def predict(self, xs, timeout=60.0):
        blob = dumps_npz_exact({"x%d" % i: x for i, x in enumerate(xs)})
        out = loads_npz_exact(self._checked("POST", "/predict", body=blob,
                                            timeout=timeout))
        outs = [out[k] for k in sorted(out, key=lambda k: int(k[1:]))]
        return outs[0] if len(outs) == 1 else outs

    def generate(self, prompt, timeout=120.0, **kw):
        req = {"prompt": [int(t) for t in np.asarray(prompt).ravel()]}
        req.update(kw)
        body = json.dumps(req).encode("utf-8")
        return json.loads(self._checked("POST", "/generate", body=body,
                                        timeout=timeout))["tokens"]

    def swap(self, blob, timeout=120.0):
        """Push checkpoint bytes; returns the new swap epoch. 409 → raises
        SwapError, replica keeps its old weights."""
        return json.loads(self._checked("POST", "/swap", body=blob,
                                        timeout=timeout))["swap_epoch"]

    def drain(self, timeout=10.0):
        return json.loads(self._checked("POST", "/drain", body=b"",
                                        timeout=timeout))

    def export_prefixes(self, timeout=60.0):
        return self._checked("GET", "/prefix/export", timeout=timeout)

    def import_prefixes(self, blob, timeout=60.0):
        return json.loads(self._checked("POST", "/prefix/import", body=blob,
                                        timeout=timeout))["imported"]

    def shutdown(self, timeout=10.0):
        try:
            self._checked("POST", "/shutdown", body=b"", timeout=timeout)
        except WorkerGone:
            pass  # it raced its own exit — that IS a successful shutdown

    # ---------------------------------------------------------- lifecycle
    def alive(self):
        if self.proc is not None:
            return self.proc.poll() is None
        try:
            self.health(timeout=2.0)
            return True
        except Exception:
            return False

    def kill9(self):
        """The drill: SIGKILL, no goodbye. In-flight work on this replica
        is lost; the router's retry path is what keeps the wave at zero
        failures."""
        if self.proc is not None:
            self.proc.kill()
        elif self.pid is not None:
            os.kill(self.pid, signal.SIGKILL)

    def reap(self, timeout_s=10.0):
        self._drop_conn()
        if self.proc is not None:
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=timeout_s)


class _Pool:
    """One model's replicas + its spawn recipe + session affinity map."""

    def __init__(self, spec=None):
        self.spec = spec
        self.workers = []
        self.rr = 0                  # round-robin tiebreak cursor
        self.affinity = {}           # session id -> WorkerHandle


class FleetRouter:
    """The fleet frontend: per-model replica pools behind one routing
    surface. Thread-safe; every public call may be issued from concurrent
    client threads (the bench fires waves exactly that way)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._models = {}
        self.events = deque(maxlen=512)   # (t, event, detail) audit trail
        self.retries = 0                  # requests re-routed to a sibling
        self.workers_lost = 0             # replicas removed as WorkerGone

    def _event(self, event, **detail):
        self.events.append({"t": round(time.time(), 3), "event": event,
                            **detail})

    # ---------------------------------------------------------- registry
    def register(self, model="default", spec=None, workers=0):
        """Register a model pool (name → spawn recipe), optionally spawning
        ``workers`` replicas now. Multi-model multiplexing is just multiple
        register() calls — pools share this router and its client threads."""
        with self._lock:
            pool = self._models.get(model)
            if pool is None:
                pool = self._models[model] = _Pool(spec)
            elif spec is not None:
                pool.spec = spec
        for _ in range(int(workers)):
            self.scale_out(model)
        return self

    def adopt(self, handle, model="default"):
        """Add an externally-started replica (tests; or workers spawned by
        a supervisor the router doesn't own)."""
        with self._lock:
            pool = self._models.setdefault(model, _Pool())
            pool.workers.append(handle)
        self._event("adopt", model=model, worker=handle.name)
        return handle

    def workers(self, model="default"):
        with self._lock:
            return list(self._models[model].workers)

    def models(self):
        with self._lock:
            return sorted(self._models)

    def scale_out(self, model="default", port=0):
        """Spawn one snapshot-warm replica from the pool's spec and add it
        to rotation once READY."""
        with self._lock:
            spec = self._models[model].spec
        if spec is None:
            raise ServeError("pool %r has no WorkerSpec — register(spec=...) "
                             "before scale_out" % model)
        handle = WorkerHandle.spawn(spec, port=port)
        with self._lock:
            self._models[model].workers.append(handle)
        self._event("scale_out", model=model, worker=handle.name,
                    pid=handle.pid)
        return handle

    # ----------------------------------------------------------- routing
    def _remove(self, model, handle, why):
        with self._lock:
            pool = self._models[model]
            if handle in pool.workers:
                pool.workers.remove(handle)
                self.workers_lost += 1
                for sess in [s for s, w in pool.affinity.items()
                             if w is handle]:
                    del pool.affinity[sess]
        self._event("worker_lost", model=model, worker=handle.name, why=why)
        handle.reap(timeout_s=2.0)

    def _pick(self, model, exclude=(), session=None):
        """Least-loaded pick: scrape each candidate's /health gauges, take
        the smallest queue_depth + tokens_in_flight, round-robin on ties.
        Sticky sessions short-circuit to their worker while it's healthy."""
        with self._lock:
            pool = self._models[model]
            candidates = [w for w in pool.workers if w not in exclude]
            sticky = pool.affinity.get(session) if session else None
        if sticky is not None and sticky in candidates:
            if sticky.load_score() is not None:
                return sticky
        scored = []
        for w in candidates:
            s = w.load_score()
            if s is None and not w.alive():
                self._remove(model, w, "dead at pick")
                continue
            if s is not None:
                scored.append((s, w))
        if not scored:
            raise WorkerGone("no routable workers for model %r" % model)
        best = min(s for s, _ in scored)
        ties = [w for s, w in scored if s == best]
        with self._lock:
            pool = self._models[model]
            w = ties[pool.rr % len(ties)]
            pool.rr += 1
            if session:
                pool.affinity[session] = w
        return w

    def _route(self, model, call, session=None):
        """Try distinct replicas until one answers: WorkerGone removes and
        retries, ServerBusy (shed or draining) skips to a sibling. Typed
        timeouts and model errors propagate — those are answers."""
        tried = []
        last = None
        while True:
            try:
                w = self._pick(model, exclude=tried, session=session)
            except WorkerGone:
                raise last or ServerBusy(
                    "no workers available for model %r" % model)
            try:
                return call(w)
            except WorkerGone as e:
                self._remove(model, w, str(e))
                with self._lock:
                    self.retries += 1
                tried.append(w)
                last = e
            except ServerBusy as e:
                with self._lock:
                    self.retries += 1
                tried.append(w)
                last = e

    def predict(self, xs, model="default", timeout=60.0):
        """Route one inference request; retries siblings on worker loss or
        shed, so callers see an answer or a typed failure — never a
        stranded socket."""
        if not isinstance(xs, (list, tuple)):
            xs = [xs]
        return self._route(model, lambda w: w.predict(xs, timeout=timeout))

    def generate(self, prompt, model="default", session=None, timeout=120.0,
                 **kw):
        """Route one generation. ``session=`` pins a conversation to one
        replica so its PrefixCache keeps the KV pages warm across turns
        (and migrates them on retirement)."""
        return self._route(
            model, lambda w: w.generate(prompt, timeout=timeout, **kw),
            session=session)

    # ------------------------------------------------------------ control
    def hot_swap(self, params_file, model="default"):
        """Push a checkpoint to every replica of ``model``. Each replica
        validates structurally before flipping (409 → SwapError raised
        here, old weights keep serving) and flips atomically under its
        params seam — traffic keeps flowing through the whole push.
        Returns {worker name: new swap epoch}."""
        with open(params_file, "rb") as f:
            blob = f.read()
        epochs = {}
        for w in self.workers(model):
            epochs[w.name] = w.swap(blob)
            self._event("hot_swap", model=model, worker=w.name,
                        epoch=epochs[w.name])
        return epochs

    def retire(self, handle, model="default", drain_timeout_s=30.0):
        """Drain-then-retire: stop admissions on the replica, wait for its
        in-flight work to finish, migrate its prefix cache to the
        least-loaded sibling (sessions follow), then shut it down."""
        handle.drain()
        self._event("drain", model=model, worker=handle.name)
        deadline = time.perf_counter() + drain_timeout_s
        while time.perf_counter() < deadline:
            try:
                h = handle.health()
            except (WorkerGone, ServeError):
                break
            if (int(h.get("queue_depth") or 0)
                    + int(h.get("tokens_in_flight") or 0)
                    + int(h.get("in_flight") or 0)) == 0:
                break
            time.sleep(0.02)
        heir = None
        if handle.kind == "generative":
            with self._lock:
                siblings = [w for w in self._models[model].workers
                            if w is not handle]
            if siblings:
                try:
                    blob = handle.export_prefixes()
                    heir = self._pick(model, exclude=[handle])
                    n = heir.import_prefixes(blob)
                    self._event("prefix_migrate", model=model,
                                src=handle.name, dst=heir.name, entries=n)
                except (WorkerGone, ServeError):
                    heir = None  # migration is best-effort; retire anyway
        with self._lock:
            pool = self._models[model]
            if handle in pool.workers:
                pool.workers.remove(handle)
            for sess, w in list(pool.affinity.items()):
                if w is handle:
                    if heir is not None:
                        pool.affinity[sess] = heir
                    else:
                        del pool.affinity[sess]
        handle.shutdown()
        handle.reap()
        self._event("retire", model=model, worker=handle.name)

    # -------------------------------------------------------------- stats
    def stats(self):
        out = {"models": {}, "retries": self.retries,
               "workers_lost": self.workers_lost,
               "events": list(self.events)}
        for model in self.models():
            rows = []
            for w in self.workers(model):
                try:
                    rows.append({"name": w.name, "pid": w.pid,
                                 **w.health()})
                except (WorkerGone, ServeError) as e:
                    rows.append({"name": w.name, "pid": w.pid,
                                 "ok": False, "error": str(e)})
            out["models"][model] = rows
        return out

    def close(self):
        """Shut down every replica (drainless — callers wanting graceful
        retirement call retire() per worker first)."""
        for model in self.models():
            for w in self.workers(model):
                try:
                    w.shutdown()
                except Exception:
                    pass
                w.reap()
            with self._lock:
                self._models[model].workers.clear()
                self._models[model].affinity.clear()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class Autoscaler(threading.Thread):
    """SLO-pressure autoscaler: scale out on sustained breach, drain-then-
    retire on sustained idle (ref: mxnet-model-server's management-API
    ``scale-worker``, automated).

    Breach = aggregate p95 request latency above ``slo_p95_ms`` OR sheds
    since the last check above ``shed_rate`` of admissions. Pressure
    accumulates one point per breach sample and DECAYS one per clean
    sample (shedding is bursty — requiring strictly consecutive breaches
    would let real overload hide between samples); at ``sustain`` points
    one replica spawns (up to ``max_workers``) — a single spiky sample
    still can't trigger a process spawn. ``idle`` consecutive zero-load
    checks retire the highest-index replica (down to ``min_workers``).
    All decisions land in ``router.events``."""

    def __init__(self, router, model="default", min_workers=1, max_workers=4,
                 slo_p95_ms=100.0, shed_rate=0.02, sustain=3, idle=10,
                 interval_s=0.25):
        super().__init__(daemon=True, name="fleet-autoscaler")
        self.router = router
        self.model = model
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.slo_p95_ms = float(slo_p95_ms)
        self.shed_rate = float(shed_rate)
        self.sustain = int(sustain)
        self.idle = int(idle)
        self.interval_s = float(interval_s)
        self._halt = threading.Event()
        self._pressure = 0
        self._idle = 0
        self._last = {}              # worker name -> (requests, shed)

    def _sample(self):
        """One control-loop reading: (p95 ms, shed delta, request delta,
        live worker count, total load)."""
        p95s, shed_d, req_d, load = [], 0, 0, 0
        workers = self.router.workers(self.model)
        for w in workers:
            try:
                s = w.server_stats()
            except (WorkerGone, ServeError):
                continue
            if s.get("p95_ms") is not None:
                p95s.append(float(s["p95_ms"]))
            prev_req, prev_shed = self._last.get(w.name, (0, 0))
            req, shed = int(s.get("requests") or 0), int(s.get("shed") or 0)
            # a respawned worker restarts its counters; clamp deltas at 0
            req_d += max(0, req - prev_req)
            shed_d += max(0, shed - prev_shed)
            self._last[w.name] = (req, shed)
            load += int(s.get("queue_depth") or 0) + \
                int(s.get("tokens_in_flight") or 0)
        return (max(p95s) if p95s else None, shed_d, req_d, len(workers),
                load)

    def step(self):
        """One control decision — called by run(), and directly by tests
        (deterministic, no sleeps)."""
        p95, shed_d, req_d, n, load = self._sample()
        admitted = req_d + shed_d
        breach = ((p95 is not None and p95 > self.slo_p95_ms)
                  or (admitted > 0 and shed_d / admitted > self.shed_rate))
        if breach:
            self._pressure += 1
            self._idle = 0
            if self._pressure >= self.sustain and n < self.max_workers:
                self.router._event("autoscale_out", model=self.model,
                                   p95_ms=p95, shed=shed_d,
                                   workers=n)
                self.router.scale_out(self.model)
                self._pressure = 0
            return "breach"
        self._pressure = max(0, self._pressure - 1)
        if load == 0 and req_d == 0:
            self._idle += 1
            if self._idle >= self.idle and n > self.min_workers:
                victim = self.router.workers(self.model)[-1]
                self.router._event("autoscale_in", model=self.model,
                                   worker=victim.name, workers=n)
                self.router.retire(victim, model=self.model)
                self._idle = 0
            return "idle"
        self._idle = 0
        return "steady"

    def run(self):
        while not self._halt.wait(self.interval_s):
            try:
                self.step()
            except Exception as e:
                # the control loop outlives a failed decision (a spawn
                # that did not come up, a scrape that failed); each one is
                # in the router's events, and the next interval decides
                # again
                self.router._event("autoscale_error", model=self.model,
                                   error="%s: %s" % (type(e).__name__, e))

    def stop(self, timeout_s=5.0):
        self._halt.set()
        if self.is_alive():
            self.join(timeout=timeout_s)
