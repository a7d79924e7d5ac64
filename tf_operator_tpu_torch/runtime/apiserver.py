"""HTTP API server: the Store served over the network (port of
tf_operator_tpu/runtime/apiserver.py: the same wire contract, over the
port's own types and store collections, so either package's client
talks to either package's server).

The reference's control plane is only reachable through a remote API
server (cmd/tf-operator.v1/app/server.go:72-229 builds clientsets against
kubeconfig; the SDK talks HTTPS from anywhere,
sdk/python/kubeflow/tfjob/api/tf_job_client.py:55-100). This module gives
the TPU-native Store the same property: REST CRUD over the existing serde
wire format plus a streaming watch, so SDK clients, node agents, and
dashboards run in separate processes (or hosts) from the operator.

Wire contract (all JSON):

  GET    /healthz                         -> {"status": "ok"}
  GET    /version                         -> {"version": ...}
  GET    /apis/v1/{kind}                  -> {"items": [...],
         "resourceVersion": N, "continue": token-or-""}
         ?namespace=ns&labelSelector=k=v,k2=v2&limit=N&continue=token
         (limit pages the keyset walk; pass the returned continue token
         to fetch the next page — every object present for the whole
         walk appears exactly once)
  POST   /apis/v1/{kind}                  -> created object
  GET    /apis/v1/{kind}/{ns}/{name}      -> object
  PUT    /apis/v1/{kind}/{ns}/{name}      -> updated object
  PUT    /apis/v1/{kind}/{ns}/{name}/status -> updated object
  DELETE /apis/v1/{kind}/{ns}/{name}      -> {}
  GET    /apis/v1/watch/{kind}            -> JSON-lines stream of
         {"type": ADDED|MODIFIED|DELETED, "object": {...}}; existing
         objects replay as ADDED; blank keepalive lines every few
         seconds. ?resourceVersion=N resumes from the store's watch
         log — only events newer than N replay (no ADDED storm); an
         RV already evicted from the log degrades to the full replay.
  GET    /logs/{ns}/{pod}?follow=1&tailLines=N -> text/plain pod log,
         proxied from the owning node agent (kubelet log API analog).

Errors: {"reason": NotFound|Conflict|AlreadyExists|BadRequest,
"message": ...} with status 404/409/409/400.

Security (round 5 — the reference rides the K8s API server, so every
hop there is TLS + bearer token + RBAC; this server carries its own
equivalents, runtime/tlsutil.py):

- TLS: pass ``tls_cert``/``tls_key`` (self-signed bootstrap via
  tlsutil.ensure_self_signed); the url property flips to https.
- Bearer tokens: pass ``tokens`` ({token: role}); every request except
  /healthz and /version (liveness probes) must carry
  ``Authorization: Bearer <token>``. Role ``read-only`` may GET/watch/
  read logs; writes need ``admin``. Missing/unknown token -> 401,
  insufficient role -> 403.
- Fail-closed default: binding a non-loopback address with no tokens
  configured rejects everything but /healthz//version with 401 unless
  ``insecure=True`` is passed explicitly (loopback binds stay open for
  same-host tooling — the kubectl-proxy convention).
"""

from __future__ import annotations

import base64
import hmac
import json
import logging
import socket
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Type

from tf_operator_tpu_torch.api.serde import ApiObject
from tf_operator_tpu_torch.api.types import (
    CheckpointRecord,
    ClusterQueue,
    Endpoint,
    EventRecord,
    Node,
    Pod,
    SliceGroup,
    TenantQueue,
    TPUJob,
)
from tf_operator_tpu_torch.runtime import leaderelection, store as store_mod
from tf_operator_tpu_torch.runtime.store import Store
from tf_operator_tpu_torch.version import version_string

log = logging.getLogger("tpu_operator.apiserver")

# Collection name -> wire class. The schema registration analog
# (reference pkg/apis/tensorflow/v1/register.go).
WIRE_KINDS: Dict[str, Type[ApiObject]] = {
    store_mod.TPUJOBS: TPUJob,
    store_mod.PODS: Pod,
    store_mod.ENDPOINTS: Endpoint,
    store_mod.SLICEGROUPS: SliceGroup,
    store_mod.TENANTQUEUES: TenantQueue,
    store_mod.CLUSTERQUEUES: ClusterQueue,
    store_mod.CHECKPOINTRECORDS: CheckpointRecord,
    store_mod.EVENTS: EventRecord,
    store_mod.NODES: Node,
    leaderelection.LEASES: leaderelection.Lease,
}

_WATCH_KEEPALIVE_SECONDS = 3.0


def encode_continue(after) -> str:
    """Opaque continue token for list pagination: base64 of the last
    returned (namespace, name) key — the resume point of the store's
    keyset walk (K8s continue-token analog)."""
    return base64.urlsafe_b64encode(
        json.dumps(list(after)).encode()).decode()


def decode_continue(token: str):
    try:
        pair = json.loads(base64.urlsafe_b64decode(token.encode()))
        if (not isinstance(pair, list) or len(pair) != 2
                or not all(isinstance(x, str) for x in pair)):
            raise ValueError(pair)
        return tuple(pair)
    except Exception:
        raise _ApiError(400, "BadRequest",
                        f"malformed continue token {token!r}")


def parse_label_selector(raw: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad labelSelector segment {part!r}")
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip()
    return out


class _ApiError(Exception):
    def __init__(self, code: int, reason: str, message: str):
        super().__init__(message)
        self.code = code
        self.reason = reason
        self.message = message


def _store_call(fn, *args):
    """Run a store operation, mapping store errors to wire errors."""
    try:
        return fn(*args)
    except store_mod.AlreadyExistsError as e:
        raise _ApiError(409, "AlreadyExists", str(e))
    except store_mod.ConflictError as e:
        raise _ApiError(409, "Conflict", str(e))
    except store_mod.NotFoundError as e:
        raise _ApiError(404, "NotFound", str(e))


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "tpu-operator-api"

    # Set by APIServer via type():
    store: Store
    tokens: Optional[Dict[str, str]] = None   # token -> role
    anonymous_ok: bool = True                 # loopback bind or insecure

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.debug("%s %s", self.address_string(), fmt % args)

    # -- authn/authz -------------------------------------------------------

    _OPEN_PATHS = (("healthz",), ("version",))

    def _authorize(self, parts, write: bool) -> None:
        """401 unauthenticated / 403 insufficient role. /healthz and
        /version stay open (liveness probes)."""
        if tuple(parts) in self._OPEN_PATHS:
            return
        if self.tokens is None:
            if self.anonymous_ok:
                return
            raise _ApiError(
                401, "Unauthorized",
                "this API server is bound to a non-loopback address "
                "with no authentication configured; configure bearer "
                "tokens (--api-tokens-file) or opt out explicitly "
                "(--api-insecure)")
        auth = self.headers.get("Authorization", "")
        token = auth[7:] if auth.startswith("Bearer ") else ""
        # Constant-time comparison against EVERY stored token (the
        # hmac.compare_digest discipline ps.py/agent.py already follow):
        # a plain dict lookup leaks token-prefix timing, and an early
        # break would leak which token matched.
        role = None
        for stored, stored_role in self.tokens.items():
            if hmac.compare_digest(stored.encode(), token.encode()):
                role = stored_role
        if role is None:
            raise _ApiError(401, "Unauthorized",
                            "missing or invalid bearer token")
        if write and role != "admin":
            raise _ApiError(403, "Forbidden",
                            f"role {role!r} may not write")

    # -- plumbing ----------------------------------------------------------

    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_error_obj(self, err: _ApiError) -> None:
        # An error decided BEFORE the body was read (401/403/404 on a
        # POST/PUT) must still consume it: HTTP/1.1 keep-alive parses
        # the next request from wherever this one's bytes ended, and an
        # unread body would desync the connection into spurious 400s.
        self._drain_body()
        self._send_json(err.code,
                        {"reason": err.reason, "message": err.message})

    def _drain_body(self) -> None:
        if getattr(self, "_body_consumed", False):
            return
        self._body_consumed = True
        length = int(self.headers.get("Content-Length", "0") or "0")
        while length > 0:
            chunk = self.rfile.read(min(length, 65536))
            if not chunk:
                break
            length -= len(chunk)

    def _read_body(self) -> dict:
        self._body_consumed = True
        length = int(self.headers.get("Content-Length", "0") or "0")
        raw = self.rfile.read(length) if length else b"{}"
        try:
            data = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            raise _ApiError(400, "BadRequest", f"invalid JSON body: {e}")
        if not isinstance(data, dict):
            raise _ApiError(400, "BadRequest", "body must be a JSON object")
        return data

    def _route(self):
        """(verb-agnostic) parse path -> (kind, cls, ns, name, subresource,
        query) or raise."""
        # One handler instance serves many keep-alive requests: reset
        # the per-request body-consumption flag (_drain_body contract).
        self._body_consumed = False
        parsed = urllib.parse.urlsplit(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        query = urllib.parse.parse_qs(parsed.query)
        return parts, query

    def _kind(self, kind: str) -> Type[ApiObject]:
        cls = WIRE_KINDS.get(kind)
        if cls is None:
            raise _ApiError(404, "NotFound", f"unknown kind {kind!r}")
        return cls

    def _decode(self, cls: Type[ApiObject], data: dict) -> ApiObject:
        try:
            return cls.from_dict(data)
        except (TypeError, ValueError) as e:
            raise _ApiError(400, "BadRequest",
                            f"cannot decode {cls.__name__}: {e}")

    # -- verbs -------------------------------------------------------------

    def do_GET(self):
        try:
            parts, query = self._route()
            self._authorize(parts, write=False)
            if parts == ["healthz"]:
                return self._send_json(200, {"status": "ok"})
            if parts == ["version"]:
                return self._send_json(200, {"version": version_string()})
            if len(parts) >= 2 and parts[:1] == ["logs"]:
                return self._serve_logs(parts[1:], query)
            if parts[:2] != ["apis", "v1"] or len(parts) < 3:
                raise _ApiError(404, "NotFound", f"no route {self.path}")
            rest = parts[2:]
            if rest[0] == "watch" and len(rest) == 2:
                return self._serve_watch(rest[1], query)
            if len(rest) == 1:        # list
                cls = self._kind(rest[0])
                ns = (query.get("namespace") or [None])[0]
                selector = None
                raw_sel = (query.get("labelSelector") or [None])[0]
                if raw_sel:
                    try:
                        selector = parse_label_selector(raw_sel)
                    except ValueError as e:
                        raise _ApiError(400, "BadRequest", str(e))
                limit = None
                raw_limit = (query.get("limit") or [None])[0]
                if raw_limit:
                    try:
                        limit = int(raw_limit)
                    except ValueError:
                        raise _ApiError(400, "BadRequest",
                                        f"invalid limit {raw_limit!r}")
                    if limit < 1:
                        raise _ApiError(400, "BadRequest",
                                        "limit must be >= 1")
                after = None
                raw_cont = (query.get("continue") or [None])[0]
                if raw_cont:
                    after = decode_continue(raw_cont)
                # Frozen snapshots straight out of the watch cache: the
                # page is serialized without a single deepcopy.
                items, next_after, rv = _store_call(
                    self.store.list_page, rest[0], ns, selector, limit,
                    after)
                return self._send_json(200, {
                    "items": [o.to_dict() for o in items],
                    "resourceVersion": rv,
                    "continue": (encode_continue(next_after)
                                 if next_after else ""),
                })
            if len(rest) == 3:        # get
                self._kind(rest[0])
                obj = _store_call(self.store.get, rest[0], rest[1], rest[2])
                return self._send_json(200, obj.to_dict())
            raise _ApiError(404, "NotFound", f"no route {self.path}")
        except _ApiError as e:
            self._send_error_obj(e)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def do_POST(self):
        try:
            parts, _ = self._route()
            self._authorize(parts, write=True)
            if parts[:2] != ["apis", "v1"] or len(parts) != 3:
                raise _ApiError(404, "NotFound", f"no route {self.path}")
            kind = parts[2]
            cls = self._kind(kind)
            obj = self._decode(cls, self._read_body())
            if not obj.metadata.name:
                raise _ApiError(400, "BadRequest", "metadata.name required")
            created = _store_call(self.store.create, kind, obj)
            self._send_json(201, created.to_dict())
        except _ApiError as e:
            self._send_error_obj(e)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def do_PUT(self):
        try:
            parts, _ = self._route()
            self._authorize(parts, write=True)
            if parts[:2] != ["apis", "v1"] or len(parts) not in (5, 6):
                raise _ApiError(404, "NotFound", f"no route {self.path}")
            kind, ns, name = parts[2], parts[3], parts[4]
            status_sub = len(parts) == 6
            if status_sub and parts[5] != "status":
                raise _ApiError(404, "NotFound", f"no route {self.path}")
            cls = self._kind(kind)
            obj = self._decode(cls, self._read_body())
            obj.metadata.namespace, obj.metadata.name = ns, name
            op = (self.store.update_status if status_sub
                  else self.store.update)
            updated = _store_call(op, kind, obj)
            self._send_json(200, updated.to_dict())
        except _ApiError as e:
            self._send_error_obj(e)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def do_DELETE(self):
        try:
            parts, _ = self._route()
            self._authorize(parts, write=True)
            if parts[:2] != ["apis", "v1"] or len(parts) != 5:
                raise _ApiError(404, "NotFound", f"no route {self.path}")
            kind, ns, name = parts[2], parts[3], parts[4]
            self._kind(kind)
            _store_call(self.store.delete, kind, ns, name)
            self._send_json(200, {})
        except _ApiError as e:
            self._send_error_obj(e)
        except (BrokenPipeError, ConnectionResetError):
            pass

    # -- watch -------------------------------------------------------------

    def _serve_watch(self, kind: str, query) -> None:
        self._kind(kind)
        ns = (query.get("namespace") or [None])[0]
        since_rv = None
        raw_rv = (query.get("resourceVersion") or [None])[0]
        if raw_rv:
            try:
                since_rv = int(raw_rv)
            except ValueError:
                raise _ApiError(400, "BadRequest",
                                f"invalid resourceVersion {raw_rv!r}")
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonlines")
        self.send_header("Cache-Control", "no-cache")
        # Watch is a long-lived stream: no Content-Length, connection
        # closes when either side stops.
        self.send_header("Connection", "close")
        self.end_headers()

        import queue as _q
        events: "_q.Queue" = _q.Queue()
        # since_rv resumes from the store's watch log (replaying only
        # missed events) instead of a full ADDED storm; an evicted RV
        # silently degrades to the full replay.
        watcher = self.store.watch(kind,
                                   lambda et, obj: events.put((et, obj)),
                                   since_rv=since_rv)
        try:
            while True:
                try:
                    et, obj = events.get(timeout=_WATCH_KEEPALIVE_SECONDS)
                except _q.Empty:
                    self.wfile.write(b"\n")   # keepalive / liveness probe
                    self.wfile.flush()
                    continue
                if ns is not None and obj.metadata.namespace != ns:
                    continue
                line = json.dumps({"type": et, "object": obj.to_dict()})
                self.wfile.write(line.encode() + b"\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            watcher.stop()

    # -- log proxy ---------------------------------------------------------

    def _serve_logs(self, parts, query) -> None:
        if len(parts) != 2:
            raise _ApiError(404, "NotFound", f"no route {self.path}")
        ns, pod_name = parts
        pod = self.store.try_get(store_mod.PODS, ns, pod_name)
        if pod is None:
            raise _ApiError(404, "NotFound", f"pod {ns}/{pod_name} not found")
        node = None
        if pod.spec.node_name:
            node = self.store.try_get(store_mod.NODES, "default",
                                      pod.spec.node_name)
        if node is None or not node.status.log_url:
            # Same-host fallback: the local backend wrote log_path on
            # the pod status and shares a filesystem with the server.
            return self._serve_logs_local(pod, query)
        follow = (query.get("follow") or ["0"])[0] not in ("", "0", "false")
        qs = urllib.parse.urlencode(
            {k: v[0] for k, v in query.items()}, safe="=")
        url = f"{node.status.log_url}/logs/{ns}/{pod_name}"
        if qs:
            url = f"{url}?{qs}"
        try:
            # A follow stream can be idle for minutes between chunks —
            # no socket timeout (the agent closes it when the pod ends).
            upstream = urllib.request.urlopen(
                url, timeout=None if follow else 30)
        except OSError as e:
            raise _ApiError(502, "BadGateway",
                            f"node agent {pod.spec.node_name}: {e}")
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            while True:
                # read1: forward each upstream chunk as it arrives —
                # read(n) would buffer 64KB before sending anything,
                # stalling live follows.
                chunk = upstream.read1(65536)
                if not chunk:
                    break
                self.wfile.write(chunk)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            upstream.close()

    def _serve_logs_local(self, pod: Pod, query) -> None:
        follow = (query.get("follow") or ["0"])[0] not in ("", "0", "false")
        if follow:
            return self._follow_logs_local(pod)
        path = pod.status.log_path
        text = b""
        if path:
            try:
                with open(path, "rb") as f:
                    text = f.read()
            except OSError:
                text = b""
        tail = (query.get("tailLines") or [None])[0]
        if tail is not None:
            try:
                n = int(tail)
            except ValueError:
                raise _ApiError(400, "BadRequest", "tailLines must be int")
            lines = text.splitlines()[-n:] if n > 0 else []
            text = b"\n".join(lines)
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Content-Length", str(len(text)))
        self.end_headers()
        self.wfile.write(text)

    def _follow_logs_local(self, pod: Pod) -> None:
        """Live tail for pods run by the in-process backend (no node
        agent to proxy to): stream appended bytes until the pod reaches
        a terminal phase and the file is drained."""
        import time as _time

        from tf_operator_tpu_torch.api.types import PodPhase

        self.send_response(200)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Connection", "close")
        self.end_headers()
        ns, name = pod.metadata.namespace, pod.metadata.name
        pos = 0
        try:
            while True:
                current = self.store.try_get(store_mod.PODS, ns, name)
                path = current.status.log_path if current else ""
                chunk = b""
                if path:
                    try:
                        with open(path, "rb") as f:
                            f.seek(pos)
                            chunk = f.read(65536)
                    except OSError:
                        pass
                if chunk:
                    pos += len(chunk)
                    self.wfile.write(chunk)
                    self.wfile.flush()
                    continue
                if current is None or current.status.phase in (
                        PodPhase.SUCCEEDED, PodPhase.FAILED):
                    return
                _time.sleep(0.05)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass


def _is_loopback_host(host: str) -> bool:
    """Only a host that can ONLY be reached from this machine counts.
    '' and '::' are bind-ALL-interfaces conventions (ThreadingHTTPServer
    binds INADDR_ANY for ''; ps.py uses '' the same way), so they must
    fail closed — treating them as loopback would serve an
    unauthenticated API on every interface."""
    if host == "localhost":
        return True
    if host in ("", "::"):
        return False
    try:
        import ipaddress

        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


class APIServer:
    """Serve a Store over HTTP(S) on a background thread (see module
    docstring for the auth/TLS contract)."""

    def __init__(self, store: Store, host: str = "127.0.0.1",
                 port: int = 0,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 tokens: Optional[Dict[str, str]] = None,
                 insecure: bool = False):
        if bool(tls_cert) != bool(tls_key):
            raise ValueError("tls_cert and tls_key must be set together")
        handler = type("BoundHandler", (_Handler,), {
            "store": store,
            "tokens": dict(tokens) if tokens else None,
            "anonymous_ok": insecure or _is_loopback_host(host),
        })
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._tls = bool(tls_cert)
        if tls_cert:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            self._httpd.socket = ctx.wrap_socket(self._httpd.socket,
                                                 server_side=True)
        if (tokens is None and not insecure
                and not _is_loopback_host(host)):
            log.warning(
                "API server binding %s with no authentication: all "
                "requests except /healthz//version will be rejected "
                "with 401 (configure tokens or pass insecure=True)",
                host)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        scheme = "https" if self._tls else "http"
        return f"{scheme}://{host}:{port}"

    def start(self) -> "APIServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="apiserver", daemon=True)
        self._thread.start()
        log.info("API server listening on %s", self.url)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def wait_for_server(url: str, timeout: float = 10.0,
                    ca_file: Optional[str] = None) -> None:
    """Block until /healthz answers (process-startup rendezvous).
    /healthz is unauthenticated by design; ``ca_file`` verifies a
    self-signed TLS server."""
    import ssl
    import time

    deadline = time.monotonic() + timeout
    last: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            ctx = None
            if url.startswith("https"):
                # Built inside the loop: with a self-signed bootstrap
                # the server process writes ca_file at startup, so it
                # may not exist on the first probes.
                ctx = ssl.create_default_context(cafile=ca_file)
            with urllib.request.urlopen(f"{url}/healthz", timeout=2,
                                        context=ctx) as r:
                if r.status == 200:
                    return
        except (OSError, socket.timeout) as e:
            last = e
        time.sleep(0.05)
    raise TimeoutError(f"API server at {url} not ready: {last}")
