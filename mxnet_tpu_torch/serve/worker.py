"""serve.worker: one fleet replica as a subprocess (counterpart of
``mxnet_tpu/serve/worker.py``; ref: mxnet-model-server's worker processes
behind its frontend router).

A worker wraps ONE live server (``ModelServer`` or ``GenerativeServer``)
and extends its ``MetricsHTTPServer`` listener into the fleet's data plane,
so a replica has one port for traffic, control and observability:

* data: POST ``/predict`` (npz in, npz out, dtype-exact through
  ``util.dumps_npz_exact``: bfloat16 crosses as bfloat16), POST
  ``/generate`` (JSON in, JSON token list out);
* control: POST ``/swap`` (a checkpoint as raw npz bytes; a mismatched
  one is refused with 409 and the old weights keep serving), POST
  ``/drain`` (admit nothing new, finish what is in flight), GET
  ``/prefix/export`` and POST ``/prefix/import`` (prefix-cache migration
  when a worker retires), POST ``/shutdown``;
* observability: the listener's ``/metrics``, ``/snapshot`` and
  ``/health``, plus GET ``/server_stats`` (this server's ``stats()``, what
  the autoscaler reads).

Launch: ``python -m mxnet_tpu_torch.serve.worker --snapshot PREFIX
[--kwargs JSON] [--model module:fn]`` (a serving snapshot, every program
captured before the first request) or ``--factory module:fn`` /
``--factory path/to/file.py:fn`` where ``fn()`` returns a ready server.
The device is what the snapshot's ``--kwargs`` (``{"device": "cuda"}``)
or the factory says: a worker inherits no ``with ctx:``, and falls back to
no device it was not given. The process prints ONE ready line of JSON
(``{"ready": true, "port": N, "pid": P, ...}``) on stdout, arms the
retrace watchdog, and serves until ``/shutdown`` or a signal.

Errors map to the statuses the router routes on: 503 ``ServerBusy`` or
draining (try a sibling), 504 ``ServeTimeout``, 409 ``SwapError``, 500
anything else. A connection that fails (the worker died) is ``WorkerGone``
on the router's side.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading

import numpy as np

from ..checkpoint import SwapError
from ..util import dumps_npz_exact, loads_npz_exact
from .batcher import ServeError, ServerBusy, ServeTimeout


def _json_reply(status, obj):
    return status, "application/json", json.dumps(
        obj, sort_keys=True, default=str).encode("utf-8")


def _error_reply(e):
    """A serve failure as the status code the fleet router routes on."""
    if isinstance(e, ServerBusy):
        status = 503
    elif isinstance(e, ServeTimeout):
        status = 504
    elif isinstance(e, SwapError):
        status = 409
    else:
        status = 500
    return _json_reply(status, {"error": type(e).__name__, "message": str(e)})


def _host(t):
    """A decoded wire tensor as numpy where numpy holds its dtype (the
    servers' input path), else the CPU tensor itself."""
    try:
        return t.numpy()
    except TypeError:  # bfloat16, fp8
        return t


class ServeWorker:
    """One replica: a live server plus the fleet routes on its listener.

    Usable in-process (tests put a ServeWorker around a local server to
    drive the HTTP surface without a subprocess); :func:`main` is the
    fleet's path, one worker a process, spawned and reaped by
    ``serve.fleet.FleetRouter``."""

    def __init__(self, server, port=0):
        self.server = server
        # duck-typed: only the generative scheduler migrates prefix KV
        self.kind = ("generative" if hasattr(server, "import_prefixes")
                     else "model")
        self.draining = False
        if server._metrics_port is None:
            server._metrics_port = int(port)
        server.start()
        self.http = server.metrics_http
        if self.http is None:
            raise ServeError("the worker needs the server's HTTP listener: "
                             "pass metrics_port (0 = ephemeral) or let the "
                             "worker set it before start()")
        # /health gains the draining flag: a router must stop picking a
        # draining replica though it is alive and warm
        self.http.health_fn = self._health
        self.http.post_routes["/predict"] = self._r_predict
        self.http.post_routes["/generate"] = self._r_generate
        self.http.post_routes["/swap"] = self._r_swap
        self.http.post_routes["/drain"] = self._r_drain
        self.http.post_routes["/shutdown"] = self._r_shutdown
        self.http.get_routes["/server_stats"] = self._r_stats
        self.http.get_routes["/prefix/export"] = self._r_prefix_export
        self.http.post_routes["/prefix/import"] = self._r_prefix_import
        self._shutdown = threading.Event()

    @property
    def port(self):
        return self.http.port

    def describe(self):
        """The ready line's payload."""
        h = self.server.health()
        return {"ready": True, "port": self.port, "pid": os.getpid(),
                "kind": self.kind, "warm": bool(h.get("warm")),
                "name": self.server.name}

    # ------------------------------------------------------------- routes
    def _health(self):
        h = self.server.health()
        h["draining"] = self.draining
        return h

    def _r_stats(self, query):
        return _json_reply(200, self.server.stats())

    def _r_predict(self, body, query):
        if self.draining:
            return _error_reply(ServerBusy("draining"))
        try:
            arrays = loads_npz_exact(body)
            xs = [_host(arrays[k])
                  for k in sorted(arrays, key=lambda k: int(k[1:]))]
            outs = self.server.predict(*xs)
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            return 200, "application/octet-stream", dumps_npz_exact(
                {"y%d" % i: o for i, o in enumerate(outs)})
        except Exception as e:
            return _error_reply(e)

    def _r_generate(self, body, query):
        if self.draining:
            return _error_reply(ServerBusy("draining"))
        try:
            req = json.loads(body.decode("utf-8"))
            stream = self.server.submit(
                np.asarray(req["prompt"], np.int32),
                max_new_tokens=int(req.get("max_new_tokens", 16)),
                temperature=float(req.get("temperature", 0.0)),
                seed=int(req.get("seed", 0)),
                priority=int(req.get("priority", 0)),
                timeout_ms=req.get("timeout_ms"))
            toks = stream.result(timeout_s=float(req.get("result_timeout_s",
                                                         60.0)))
            return _json_reply(200, {"tokens": [int(t) for t in toks]})
        except Exception as e:
            return _error_reply(e)

    def _r_swap(self, body, query):
        """Weight hot swap: the checkpoint is the request body (raw npz
        bytes). A refusal (409) leaves the old weights serving: the check
        runs before any parameter is touched."""
        try:
            fd, path = tempfile.mkstemp(suffix=".params",
                                        prefix="mxtpu-swap-")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(body)
                epoch = self.server.swap_parameters(path)
            finally:
                os.unlink(path)
            return _json_reply(200, {"swap_epoch": epoch})
        except Exception as e:
            return _error_reply(e)

    def _r_drain(self, body, query):
        """Admit no new work (the data routes answer 503) and finish what
        is in flight: the first half of drain-then-retire."""
        self.draining = True
        g = self.server.metrics.load_gauges()
        g["draining"] = True
        return _json_reply(200, g)

    def _r_prefix_export(self, query):
        if self.kind != "generative":
            return _json_reply(200, {"entries": 0})
        arrays, n = {}, 0
        for tok, k_stack, v_stack, plen, last in \
                self.server.export_prefixes():
            arrays["tok%d" % n] = np.asarray(tok, np.int32)
            arrays["k%d" % n] = k_stack
            arrays["v%d" % n] = v_stack
            arrays["plen%d" % n] = np.asarray(plen, np.int64)
            arrays["last%d" % n] = last
            n += 1
        arrays["count"] = np.asarray(n, np.int64)
        return 200, "application/octet-stream", dumps_npz_exact(arrays)

    def _r_prefix_import(self, body, query):
        if self.kind != "generative":
            return _json_reply(200, {"imported": 0})
        arrays = loads_npz_exact(body)
        count = int(arrays["count"]) if "count" in arrays else 0
        entries = [(arrays["tok%d" % i].numpy().astype(np.int32),
                    arrays["k%d" % i], arrays["v%d" % i],
                    int(arrays["plen%d" % i]), arrays["last%d" % i])
                   for i in range(count)]
        return _json_reply(200,
                           {"imported": self.server.import_prefixes(entries)})

    def _r_shutdown(self, body, query):
        # reply first, then the main thread tears down: the listener must
        # not close under its own handler
        self._shutdown.set()
        return _json_reply(200, {"ok": True})

    # ---------------------------------------------------------- lifecycle
    def wait(self):
        """Block until /shutdown (the serving loop of :func:`main`)."""
        self._shutdown.wait()

    def close(self, reason="worker retired"):
        self.server.stop(reason=reason)


def _resolve(spec):
    """``module.sub:fn`` or ``path/to/file.py:fn`` -> the callable (the
    file form because ``tools/`` and ``tests/`` are not packages)."""
    target, _, attr = spec.rpartition(":")
    if not target:
        raise ValueError("factory spec %r needs module:fn or file.py:fn"
                         % spec)
    if target.endswith(".py"):
        import importlib.util

        name = "_mxtpu_worker_factory_%s" % (
            os.path.basename(target)[:-3].replace("-", "_"))
        mod_spec = importlib.util.spec_from_file_location(name, target)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
    else:
        import importlib

        mod = importlib.import_module(target)
    return getattr(mod, attr)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.serve.worker",
        description="one fleet replica: serve a model over HTTP until "
                    "shutdown")
    p.add_argument("--snapshot", default=None,
                   help="serving snapshot prefix (serve.load(..., "
                        "snapshot=True): every program captured before "
                        "the first request)")
    p.add_argument("--factory", default=None,
                   help="module:fn or file.py:fn returning a ready server")
    p.add_argument("--model", default=None,
                   help="factory of the decode model (a generative "
                        "snapshot holds parameters and programs, not code)")
    p.add_argument("--kwargs", default="{}",
                   help="JSON kwargs of the snapshot's server constructor, "
                        "the device among them")
    p.add_argument("--port", type=int, default=0,
                   help="listener port (0 = ephemeral, reported on the "
                        "ready line)")
    args = p.parse_args(argv)
    if (args.snapshot is None) == (args.factory is None):
        p.error("exactly one of --snapshot / --factory")
    if args.factory is not None:
        server = _resolve(args.factory)()
    else:
        from . import load

        model = _resolve(args.model)() if args.model else None
        server = load(args.snapshot, snapshot=True, model=model,
                      **json.loads(args.kwargs))
    # a replica reaches its first request with nothing left to build: the
    # watchdog reports any later build (scrapeable through /snapshot)
    from ..observability import arm_watchdog

    arm_watchdog()
    worker = ServeWorker(server, port=args.port)
    print(json.dumps(worker.describe(), sort_keys=True), flush=True)
    try:
        worker.wait()
    except KeyboardInterrupt:
        pass
    worker.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
