"""Serving gateway: the HTTP front door over the request spool (copy of
``tf_operator_tpu/serve/gateway.py``).

The spool protocol (``serve/worker.py``) is transport-free: any producer
that can atomically rename a JSON file can submit work. This module is the
HTTP producer: it terminates client connections, maps auth tokens to
tenant QoS lanes, enforces the ``maxQueueDepth`` backpressure contract at
admission, and streams token responses back as chunked NDJSON::

    POST /v1/generate  {"prompt": [1,2,3], "maxNewTokens": 8}
      Authorization: Bearer <token>        (or X-Auth-Token: <token>)

    401  unknown/missing token (when a token map is configured)
    400  malformed body / empty prompt
    429  spool backlog at maxQueueDepth  + Retry-After: <seconds>
    200  accepted: chunked NDJSON, one {"token": t} line per generated
         token, then a {"done": true, ...} trailer with servedBy and
         ttftSeconds
    504  no replica produced a response within --timeout

The gateway rejects before writing the spool, so the backlog stays bounded
however many gateways front it. With no token map the gateway is open and
every request rides the ``default`` lane. Tokens stream when the response
lands in ``done/``. The spool, the wire format and the metric names are
the JAX gateway's, so either package's gateway fronts either package's
workers. One difference: each answer is counted in
``gateway_requests`` (and a stream timed in
``gateway_streaming_seconds``) before its last bytes are written, so a
client that has read a response finds it counted. The gateway counts
into ``runtime.metrics``, the operator's one registry, so its
``/metrics`` renders the whole catalogue, and a gateway started in the
operator (``--enable-serving-gateway``) shows on the operator's own.

    python -m tf_operator_tpu_torch.serve.gateway --spool DIR --port 8600
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from tf_operator_tpu_torch.runtime import metrics

log = logging.getLogger("tpu_operator.serve.gateway")

MAX_BODY_BYTES = 1 << 20


def parse_token_map(raw: str) -> Dict[str, str]:
    """Parse the ``token=tenant,token=tenant`` rendering (CLI
    ``--gateway-tokens`` / env ``TPUJOB_GATEWAY_TOKENS``). Malformed
    entries are skipped, like parse_tenant_weights — the gateway must
    come up even if the token topology changed under it."""
    tokens: Dict[str, str] = {}
    for entry in (raw or "").split(","):
        token, sep, tenant = entry.strip().partition("=")
        if not sep or not token or not tenant.strip():
            continue
        tokens[token] = tenant.strip()
    return tokens


class SpoolClient:
    """The gateway's half of the spool protocol: atomic submit into
    pending/, response pickup from done/. Mirrors serve/worker.py
    Spool's write discipline (tmp + rename) so a crash mid-submit never
    leaves a half-written request claimable."""

    def __init__(self, root: str):
        self.root = root
        self.pending = os.path.join(root, "pending")
        self.done = os.path.join(root, "done")
        for d in (self.pending, self.done):
            os.makedirs(d, exist_ok=True)

    def depth(self) -> int:
        """Requests waiting for any replica (the admission signal)."""
        try:
            return sum(1 for n in os.listdir(self.pending)
                       if n.endswith(".json"))
        except OSError:
            return 0

    def submit(self, request_id: str, tenant: str, prompt: List[int],
               max_new_tokens: int) -> None:
        path = os.path.join(self.pending, f"{request_id}.json")
        payload = {"id": request_id, "tenant": tenant, "prompt": prompt,
                   "maxNewTokens": max_new_tokens}
        with open(path + ".tmp", "w") as f:
            json.dump(payload, f, sort_keys=True)
        os.replace(path + ".tmp", path)

    def take_response(self, request_id: str) -> Optional[dict]:
        """Consume done/<id>.json (the gateway delivers it; nothing
        else will)."""
        path = os.path.join(self.done, f"{request_id}.json")
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return None
        try:
            os.unlink(path)
        except OSError:
            pass
        return data

    def retract(self, request_id: str) -> bool:
        """Best-effort unsubmit of a timed-out request; False when a
        replica already claimed it (the work may still complete — its
        orphaned response is harmless)."""
        try:
            os.unlink(os.path.join(self.pending, f"{request_id}.json"))
            return True
        except OSError:
            return False


class _Handler(BaseHTTPRequestHandler):
    gateway: "GatewayServer"
    protocol_version = "HTTP/1.1"

    # -- plumbing --------------------------------------------------------

    def _count(self, code: int) -> None:
        metrics.gateway_requests.inc(code=str(code))

    def _send_json(self, code: int, payload: dict,
                   headers: Optional[Dict[str, str]] = None) -> None:
        body = (json.dumps(payload) + "\n").encode()
        self._count(code)
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args) -> None:
        log.debug("http: " + fmt, *args)

    # -- routes ----------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            body = b"ok\n"
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path == "/metrics":
            body = metrics.REGISTRY.render_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self._send_json(404, {"error": f"unknown path {path}"})

    def do_POST(self) -> None:  # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        if path != "/v1/generate":
            self._send_json(404, {"error": f"unknown path {path}"})
            return
        self._generate()

    # -- the front door --------------------------------------------------

    def _auth_tenant(self) -> Optional[str]:
        """Token -> tenant lane; None = unauthorized. An empty token
        map means an open gateway on the default lane."""
        gw = self.gateway
        if not gw.tokens:
            return gw.default_tenant
        token = self.headers.get("X-Auth-Token", "")
        if not token:
            auth = self.headers.get("Authorization", "")
            if auth.startswith("Bearer "):
                token = auth[len("Bearer "):].strip()
        return gw.tokens.get(token)

    def _parse_body(self) -> Optional[dict]:
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            return None
        if not 0 < length <= MAX_BODY_BYTES:
            return None
        try:
            data = json.loads(self.rfile.read(length))
        except (OSError, ValueError):
            return None
        return data if isinstance(data, dict) else None

    def _generate(self) -> None:
        gw = self.gateway
        tenant = self._auth_tenant()
        if tenant is None:
            self._send_json(401, {"error": "unknown or missing auth "
                                           "token"})
            return
        data = self._parse_body()
        if data is None:
            self._send_json(400, {"error": "body must be a JSON object "
                                           "with a 'prompt' token list"})
            return
        try:
            prompt = [int(t) for t in data.get("prompt", [])]
            max_new = int(data.get("maxNewTokens",
                                   gw.max_tokens_per_request))
        except (TypeError, ValueError):
            self._send_json(400, {"error": "prompt must be a list of "
                                           "ints; maxNewTokens an int"})
            return
        if not prompt or max_new < 1:
            self._send_json(400, {"error": "empty prompt or non-positive "
                                           "maxNewTokens"})
            return
        # Backpressure at admission: the spool backlog IS the queue the
        # ServingPolicy bounds. Rejecting here (not after the write)
        # keeps the backlog bounded however many gateways front it.
        if gw.spool.depth() >= gw.max_queue_depth:
            self._send_json(
                429,
                {"error": "serving backlog at maxQueueDepth; retry "
                          "after the autoscaler reacts",
                 "retryAfterSeconds": gw.retry_after_seconds},
                headers={"Retry-After":
                         str(int(gw.retry_after_seconds))})
            return

        request_id = uuid.uuid4().hex[:16]
        t0 = time.monotonic()
        gw.spool.submit(request_id, tenant,
                        prompt, min(max_new, gw.max_tokens_per_request))
        deadline = t0 + gw.timeout_seconds
        response = None
        while time.monotonic() < deadline and not gw.closing:
            response = gw.spool.take_response(request_id)
            if response is not None:
                break
            time.sleep(gw.poll_interval)
        if response is None:
            retracted = gw.spool.retract(request_id)
            self._send_json(
                504, {"error": "no replica produced a response in time",
                      "requestId": request_id,
                      "retracted": retracted})
            return

        # Stream: chunked NDJSON, one token per line, then the trailer.
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for token in response.get("tokens", []):
                self._chunk(json.dumps({"token": token}) + "\n")
            self._chunk(json.dumps({
                "done": True, "id": response.get("id", request_id),
                "tenant": response.get("tenant", tenant),
                "servedBy": response.get("servedBy", ""),
                "ttftSeconds": response.get("ttftSeconds")}) + "\n")
            metrics.gateway_streaming_seconds.observe(time.monotonic() - t0)
            self._count(200)
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            return  # client went away mid-stream; nothing to unwind

    def _chunk(self, text: str) -> None:
        data = text.encode()
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")


class GatewayServer:
    """Serves the front door on a background thread; port 0 =
    ephemeral (tests)."""

    def __init__(self, spool_root: str, port: int = 8600,
                 host: str = "127.0.0.1",
                 tokens: Optional[Dict[str, str]] = None,
                 default_tenant: str = "default",
                 max_queue_depth: int = 256,
                 max_tokens_per_request: int = 64,
                 retry_after_seconds: float = 2.0,
                 timeout_seconds: float = 30.0,
                 poll_interval: float = 0.01):
        self.spool = SpoolClient(spool_root)
        self.tokens = dict(tokens or {})
        self.default_tenant = default_tenant
        self.max_queue_depth = max_queue_depth
        self.max_tokens_per_request = max_tokens_per_request
        self.retry_after_seconds = retry_after_seconds
        self.timeout_seconds = timeout_seconds
        self.poll_interval = poll_interval
        self.closing = False
        handler = type("Handler", (_Handler,), {"gateway": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "GatewayServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serving-gateway",
                                        daemon=True)
        self._thread.start()
        log.info("serving gateway on :%d (spool=%s, %d token(s))",
                 self.port, self.spool.root, len(self.tokens))
        return self

    def stop(self) -> None:
        self.closing = True  # unblocks in-flight response waits
        if self._thread is not None:
            # shutdown() blocks on serve_forever acknowledging; only
            # safe when the serve thread actually ran.
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="HTTP front door over a serving spool")
    parser.add_argument("--spool", default=None,
                        help="spool root (default: TPUJOB_SERVE_SPOOL)")
    parser.add_argument("--port", type=int, default=8600)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--tokens", default=None,
                        help="token=tenant,... auth map (default: "
                             "TPUJOB_GATEWAY_TOKENS; empty = open "
                             "gateway on the default lane)")
    parser.add_argument("--max-queue-depth", type=int, default=256)
    parser.add_argument("--max-tokens", type=int, default=64)
    parser.add_argument("--retry-after", type=float, default=2.0)
    parser.add_argument("--timeout", type=float, default=30.0)
    args = parser.parse_args(argv)

    spool_root = args.spool or os.environ.get("TPUJOB_SERVE_SPOOL", "")
    if not spool_root:
        print("serving gateway: no spool (--spool or "
              "TPUJOB_SERVE_SPOOL)", flush=True)
        return 2
    raw_tokens = (args.tokens if args.tokens is not None
                  else os.environ.get("TPUJOB_GATEWAY_TOKENS", ""))
    server = GatewayServer(
        spool_root, port=args.port, host=args.host,
        tokens=parse_token_map(raw_tokens),
        max_queue_depth=args.max_queue_depth,
        max_tokens_per_request=args.max_tokens,
        retry_after_seconds=args.retry_after,
        timeout_seconds=args.timeout)
    server.start()
    print(f"serving gateway on :{server.port} (spool={spool_root})",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
