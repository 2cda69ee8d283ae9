"""Opt-in ``/metrics`` HTTP endpoint — stdlib only, no server framework
(counterpart of ``mxnet_tpu/observability/http.py``).

The scrape surface mxnet-model-server exposed on its management port,
rebuilt on ``http.server``: GET ``/metrics`` returns the Prometheus text
exposition of ``observability.snapshot()``, GET ``/snapshot`` (or
``/stats``) the stable JSON form, and GET ``/health`` a CHEAP liveness
probe — a tiny JSON payload (``ok`` + whatever the owning server's
``health_fn`` reports: warmup-complete flag, queue-depth and
tokens-in-flight gauges) that reads two counters, never sorts a latency
ring and never touches device state, so a fleet router can scrape it per
routing pick. Bound to loopback by default; a serving replica opts in
with ``ModelServer(..., metrics_port=9090)`` /
``GenerativeServer(..., metrics_port=9090)`` (0 = ephemeral port, read
back from ``.port`` — how tests avoid collisions).

Extra GET/POST routes registered on ``get_routes``/``post_routes`` ride
the same listener: the fleet worker's data and control routes
(``serve.worker``).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class MetricsHTTPServer:
    """Background thread serving the observability snapshot. ``close()``
    (or the owning server's ``stop()``) shuts it down; scrapes never touch
    the dispatch path — they read counters and bounded rings.

    ``health_fn``: zero-arg callable returning a dict merged into the
    ``/health`` payload (e.g. a server's warm flag + load gauges). Must be
    cheap — the router calls it on the routing path. An exception inside
    it flips ``ok`` to False rather than 500ing the probe.

    ``get_routes`` / ``post_routes``: path -> handler extension points.
    GET handlers take the query string; POST handlers take (body bytes,
    query string). Both return ``(status, content_type, body_bytes)``;
    an exception becomes a 500 with a JSON error envelope.
    """

    def __init__(self, port=0, host="127.0.0.1", health_fn=None):
        from . import prometheus, snapshot

        self.health_fn = health_fn
        self.get_routes = {}
        self.post_routes = {}
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            # the worker data plane rides this listener: keep-alive saves a
            # TCP handshake per routed request
            protocol_version = "HTTP/1.1"

            def _reply(self, status, ctype, body):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _run_route(self, fn, *args):
                try:
                    status, ctype, body = fn(*args)
                except Exception as e:
                    body = json.dumps({"error": type(e).__name__,
                                       "message": str(e)}).encode("utf-8")
                    status, ctype = 500, "application/json"
                self._reply(status, ctype, body)

            def do_GET(self):  # noqa: N802 (stdlib API name)
                # device=True: the card's allocator counters, a host read
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    body = prometheus(device=True).encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path in ("/snapshot", "/stats"):
                    body = json.dumps(snapshot(device=True), indent=1,
                                      sort_keys=True,
                                      default=str).encode("utf-8")
                    ctype = "application/json"
                elif path == "/health":
                    # cheap by contract: counters and flags only, so a
                    # router can afford one scrape per routing window
                    payload = {"ok": True}
                    if outer.health_fn is not None:
                        try:
                            payload.update(outer.health_fn() or {})
                        except Exception as e:
                            payload = {"ok": False, "error": repr(e)}
                    body = json.dumps(payload, sort_keys=True,
                                      default=str).encode("utf-8")
                    ctype = "application/json"
                elif path in outer.get_routes:
                    self._run_route(outer.get_routes[path], query)
                    return
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self._reply(200, ctype, body)

            def do_POST(self):  # noqa: N802 (stdlib API name)
                path, _, query = self.path.partition("?")
                fn = outer.post_routes.get(path)
                if fn is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                self._run_route(fn, body, query)

            def log_message(self, *a):  # scrapes are not stdout events
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="mxtpu-metrics")
        self._thread.start()

    def url(self, path="/metrics"):
        return "http://%s:%d%s" % (self.host, self.port, path)

    def close(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
