"""Monitoring HTTP endpoint: /metrics + /healthz (+ /debug/*) (port of
tf_operator_tpu/runtime/monitoring.py over the port's metrics registry).

Reference parity: startMonitoring (cmd/tf-operator.v1/main.go:39-50)
serves promhttp + net/http/pprof on -monitoring-port (default 8443).
Python profiling is served as a plain-text thread dump at /debug/stacks
instead of pprof. The flight recorder (runtime/trace.py) adds two JSON
surfaces: /debug/traces (retained reconcile traces + phase totals) and
/debug/jobs/<ns>/<name> (the per-job decision journal —
docs/observability.md).
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tf_operator_tpu_torch.runtime import trace as trace_mod
from tf_operator_tpu_torch.runtime.metrics import REGISTRY, Registry
from tf_operator_tpu_torch.version import version_string

log = logging.getLogger("tpu_operator.monitoring")


def _thread_dump() -> str:
    frames = sys._current_frames()
    out = []
    for t in threading.enumerate():
        out.append(f"--- thread {t.name} (daemon={t.daemon}) ---")
        frame = frames.get(t.ident or -1)
        if frame is not None:
            out.extend(line.rstrip()
                       for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


class _Handler(BaseHTTPRequestHandler):
    registry: Registry = REGISTRY
    recorder: trace_mod.FlightRecorder = trace_mod.RECORDER
    journal: trace_mod.DecisionJournal = trace_mod.JOURNAL

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = self.registry.render_text().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/healthz":
            body = b"ok\n"
            ctype = "text/plain"
        elif path == "/version":
            body = (json.dumps({"version": version_string()}) + "\n").encode()
            ctype = "application/json"
        elif path == "/debug/stacks":
            body = _thread_dump().encode()
            ctype = "text/plain"
        elif path == "/debug/traces":
            # Served whether or not tracing is on: off = empty recorder
            # (plus whatever was retained before it was turned off).
            payload = {"enabled": trace_mod.enabled(),
                       **self.recorder.snapshot()}
            body = (json.dumps(payload) + "\n").encode()
            ctype = "application/json"
        elif path.startswith("/debug/jobs/"):
            parts = path[len("/debug/jobs/"):].split("/")
            decisions = (self.journal.decisions(parts[0], parts[1])
                         if len(parts) == 2 and all(parts) else None)
            if decisions is None:
                self._send_json(404, {
                    "error": "no decision journal for this job (unknown "
                             "job, or no control-plane decision has "
                             "touched it yet)",
                    "path": path})
                return
            self._send_json(200, {"namespace": parts[0], "name": parts[1],
                                  "decisions": decisions})
            return
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, payload: dict) -> None:
        body = (json.dumps(payload) + "\n").encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args) -> None:
        log.debug("http: " + fmt, *args)


class MonitoringServer:
    """Serves the registry on a background thread; port 0 = ephemeral."""

    def __init__(self, port: int = 8443, host: str = "127.0.0.1",
                 registry: Optional[Registry] = None,
                 recorder: Optional[trace_mod.FlightRecorder] = None,
                 journal: Optional[trace_mod.DecisionJournal] = None):
        handler = type("Handler", (_Handler,),
                       {"registry": registry or REGISTRY,
                        "recorder": recorder or trace_mod.RECORDER,
                        "journal": journal or trace_mod.JOURNAL})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="monitoring", daemon=True)
        self._thread.start()
        log.info("monitoring endpoint on :%d (/metrics /healthz "
                 "/debug/traces /debug/jobs/<ns>/<name>)", self.port)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
