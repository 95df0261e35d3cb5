"""Stdlib-threaded HTTP sidecar: ``/metrics`` (Prometheus text format),
``/healthz`` (JSON liveness), ``/slo`` (machine-readable SLO /
burn-rate alert state), and ``/profile`` (wall-clock attribution +
sampled-stack summary) without any dependency beyond ``http.server``.

The sidecar is deliberately tiny: scrapes are infrequent (seconds apart)
and the render is a single registry walk, so a ThreadingHTTPServer on a
daemon thread is plenty. It binds loopback by default for the same reason
the bridge does — it is an in-machine surface; exposure is the embedder's
call (pass ``host="0.0.0.0"`` explicitly to take that decision).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .prometheus import CONTENT_TYPE


class MetricsSidecar:
    """Serve one registry over HTTP. ``health_fn`` (optional) returns the
    JSON body for ``/healthz``; a falsy ``"ok"`` key turns the status into
    503 so load balancers can act on it. ``slo_fn`` (optional) returns the
    JSON body for ``/slo`` — by default the process-wide
    :meth:`~hashgraph_tpu_torch.obs.slo.SloEngine.state`; pass a merged-view
    callable (federation) to serve fleet-wide SLO state instead.
    ``render_fn`` (optional) overrides the ``/metrics`` text entirely —
    the federation's merged-scrape hook (one scrape, every host's
    families labelled ``host="..."`` plus fleet totals). ``profile_fn``
    (optional) returns the JSON body for ``/profile`` — by default the
    process's :func:`~hashgraph_tpu_torch.obs.attribution.attribution_report`;
    pass a merged-view callable (federation) to serve the fleet rollup
    instead."""

    def __init__(
        self,
        registry,
        host: str = "127.0.0.1",
        port: int = 0,
        health_fn=None,
        slo_fn=None,
        render_fn=None,
        profile_fn=None,
    ):
        self._registry = registry
        self._host = host
        self._port = port
        self._health_fn = health_fn
        self._render_fn = render_fn
        if slo_fn is None:
            # Late import: obs/__init__ constructs the default SloEngine
            # after importing this module.
            def slo_fn():
                from . import slo_engine

                return slo_engine.state()

        self._slo_fn = slo_fn
        if profile_fn is None:
            # Same late-import discipline as slo_fn.
            def profile_fn():
                from .attribution import attribution_report

                return attribution_report()

        self._profile_fn = profile_fn
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        if self._server is None:
            raise RuntimeError("sidecar not started")
        return self._server.server_address[:2]

    def start(self) -> tuple[str, int]:
        registry = self._registry
        health_fn = self._health_fn
        slo_fn = self._slo_fn
        render_fn = self._render_fn
        profile_fn = self._profile_fn

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib naming)
                if self.path.split("?", 1)[0] == "/metrics":
                    if render_fn is not None:
                        try:
                            text = render_fn()
                        except Exception as exc:
                            self._reply(
                                503, "text/plain", repr(exc).encode() + b"\n"
                            )
                            return
                    else:
                        text = registry.render_prometheus()
                    self._reply(200, CONTENT_TYPE, text.encode("utf-8"))
                elif self.path.split("?", 1)[0] == "/slo":
                    try:
                        payload = slo_fn()
                    except Exception as exc:
                        payload = {"error": repr(exc)}
                    self._reply(
                        200,
                        "application/json",
                        json.dumps(payload).encode("utf-8"),
                    )
                elif self.path.split("?", 1)[0] == "/profile":
                    try:
                        payload = profile_fn()
                    except Exception as exc:
                        payload = {"error": repr(exc)}
                    self._reply(
                        200,
                        "application/json",
                        json.dumps(payload).encode("utf-8"),
                    )
                elif self.path.split("?", 1)[0] == "/healthz":
                    payload = {"ok": True}
                    if health_fn is not None:
                        try:
                            payload = health_fn()
                        except Exception as exc:
                            payload = {"ok": False, "error": repr(exc)}
                    status = 200 if payload.get("ok", True) else 503
                    self._reply(
                        status,
                        "application/json",
                        json.dumps(payload).encode("utf-8"),
                    )
                else:
                    self._reply(404, "text/plain", b"not found\n")

            def _reply(self, status: int, ctype: str, body: bytes) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam stderr
                pass

        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self.address

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
