"""RemoteStore: the Store interface over the served API (port of
tf_operator_tpu/runtime/remote.py).

The reference's clientsets speak to a remote API server from any process
(app/server.go:198-229; the SDK from anywhere,
api/tf_job_client.py:55-100). RemoteStore is that client: it duck-types
the in-process Store (create/get/list/update/update_status/delete/watch
and friends), so the SDK, node agents, and the engine's controls run
unchanged against an operator in another process or on another host.

Watch is a streaming GET of JSON lines. The watcher tracks the highest
resourceVersion seen on the stream; on connection loss it reconnects
with ``?resourceVersion=<last seen>`` and the server replays only the
missed events from its watch log — no full ADDED storm. Only when the
resume point has been evicted from the log does the server fall back to
the informer relist contract (current objects replayed as ADDED), which
every consumer in this codebase already treats as idempotent.
"""

from __future__ import annotations

import json
import logging
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from tf_operator_tpu_torch.runtime import retry as retry_mod
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.apiserver import WIRE_KINDS

log = logging.getLogger("tpu_operator.remote")

# Verbs safe to replay after an ambiguous failure: GET trivially;
# PUT carries the object's resourceVersion (a replay after a landed
# write loses the CAS -> ConflictError, which every caller handles);
# DELETE replays to NotFound (level-triggered deletes handle it).
# POST (create) is NOT replayed — a landed-then-lost create would
# surface as a spurious AlreadyExists on objects the caller owns.
_IDEMPOTENT_METHODS = ("GET", "PUT", "DELETE")

_RECONNECT_DELAY = 0.5


def _ssl_context(base_url: str, ca_file: Optional[str],
                 insecure_skip_verify: bool) -> Optional[ssl.SSLContext]:
    if not base_url.startswith("https"):
        return None
    ctx = ssl.create_default_context(cafile=ca_file)
    if insecure_skip_verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx


def _authed(url: str, token: Optional[str],
            data: Optional[bytes] = None, method: Optional[str] = None,
            headers: Optional[Dict[str, str]] = None
            ) -> urllib.request.Request:
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=dict(headers or {}))
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    return req


class RemoteWatcher:
    """Store.Watcher analog over a streaming HTTP connection."""

    def __init__(self, base_url: str, kind: str,
                 handler: Callable[[str, object], None],
                 namespace: Optional[str] = None,
                 token: Optional[str] = None,
                 ssl_context: Optional[ssl.SSLContext] = None,
                 since_rv: Optional[int] = None):
        self._base = f"{base_url}/apis/v1/watch/{kind}"
        self._namespace = namespace
        # Highest resourceVersion seen on the stream; a reconnect
        # resumes from it via the server's watch log, so a dropped
        # connection no longer triggers a full ADDED replay.
        self.last_rv: Optional[int] = since_rv
        self.kind = kind
        self.handler = handler
        self._token = token
        self._ssl = ssl_context
        self._stopped = threading.Event()
        self._resp = None
        self._lock = threading.Lock()
        self.thread = threading.Thread(target=self._loop,
                                       name=f"watch-{kind}", daemon=True)
        self.thread.start()

    def _watch_url(self) -> str:
        params = {}
        if self._namespace is not None:
            params["namespace"] = self._namespace
        if self.last_rv is not None:
            params["resourceVersion"] = str(self.last_rv)
        if not params:
            return self._base
        return self._base + "?" + urllib.parse.urlencode(params)

    def _loop(self) -> None:
        cls = WIRE_KINDS[self.kind]
        auth_failures = 0
        while not self._stopped.is_set():
            try:
                try:
                    resp = urllib.request.urlopen(
                        _authed(self._watch_url(), self._token),
                        context=self._ssl)
                except urllib.error.HTTPError as e:
                    if e.code in (401, 403):
                        # NOT a transient blip: a misconfigured token
                        # never fixes itself — surface loudly and back
                        # off hard so the caller's silent handler is
                        # explicable from the logs.
                        auth_failures += 1
                        if auth_failures == 1 or auth_failures % 60 == 0:
                            log.warning(
                                "watch %s rejected with %d (%s): check "
                                "the bearer token/role; retrying",
                                self.kind, e.code, e.reason)
                        self._stopped.wait(5.0)
                        continue
                    raise
                auth_failures = 0
                with self._lock:
                    if self._stopped.is_set():
                        resp.close()
                        return
                    self._resp = resp
                for raw in resp:
                    if self._stopped.is_set():
                        return
                    raw = raw.strip()
                    if not raw:
                        continue  # keepalive
                    evt = json.loads(raw)
                    obj = cls.from_dict(evt["object"])
                    rv = obj.metadata.resource_version
                    if rv and (self.last_rv is None or rv > self.last_rv):
                        self.last_rv = rv
                    try:
                        self.handler(evt["type"], obj)
                    except Exception:
                        log.exception("watch handler error for %s", self.kind)
            except (OSError, urllib.error.URLError, ValueError,
                    AttributeError):
                # AttributeError: stop() closed the response from another
                # thread mid-read; http.client's internals race their own
                # teardown. Treat like any disconnect.
                if self._stopped.is_set():
                    return
                log.debug("watch %s disconnected; reconnecting", self.kind)
            finally:
                with self._lock:
                    if self._resp is not None:
                        try:
                            self._resp.close()
                        except Exception:
                            pass
                        self._resp = None
            self._stopped.wait(_RECONNECT_DELAY)

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            if self._resp is not None:
                try:
                    # Closing the socket unblocks the reader thread.
                    self._resp.close()
                except Exception:
                    pass
        self.thread.join(timeout=5)


class RemoteStore:
    """HTTP(S) client with the Store's surface. ``token`` rides every
    request as a bearer credential; ``ca_file`` verifies a self-signed
    server (``insecure_skip_verify`` disables verification — test/dev
    only, the kubeconfig insecure-skip-tls-verify analog)."""

    def __init__(self, base_url: str, timeout: float = 30.0,
                 token: Optional[str] = None,
                 ca_file: Optional[str] = None,
                 insecure_skip_verify: bool = False):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.token = token
        self._ssl = _ssl_context(self.base_url, ca_file,
                                 insecure_skip_verify)
        self._watchers: List[RemoteWatcher] = []
        self._lock = threading.Lock()

    # -- plumbing ----------------------------------------------------------

    def _open(self, url: str, timeout: Optional[float],
              data: Optional[bytes] = None,
              method: Optional[str] = None,
              headers: Optional[Dict[str, str]] = None):
        return urllib.request.urlopen(
            _authed(url, self.token, data=data, method=method,
                    headers=headers),
            timeout=timeout, context=self._ssl)

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None,
                 query: Optional[Dict[str, str]] = None) -> dict:
        url = f"{self.base_url}{path}"
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = None
        headers = {}
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"

        def once() -> dict:
            try:
                with self._open(url, self.timeout, data=data,
                                method=method, headers=headers) as resp:
                    return json.loads(resp.read() or b"{}")
            except urllib.error.HTTPError as e:
                payload = {}
                try:
                    payload = json.loads(e.read() or b"{}")
                except (ValueError, OSError):
                    pass
                reason = payload.get("reason", "")
                message = payload.get("message", str(e))
                if reason == "NotFound":
                    raise store_mod.NotFoundError(message)
                if reason == "AlreadyExists":
                    raise store_mod.AlreadyExistsError(message)
                if reason == "Conflict":
                    raise store_mod.ConflictError(message)
                if e.code == 429 or e.code >= 500:
                    # Server blip/throttle: retryable (classified via
                    # the shared transient taxonomy, runtime/retry.py).
                    raise retry_mod.TransientAPIError(
                        f"API error {e.code}: {message}", code=e.code)
                raise RuntimeError(f"API error {e.code}: {message}")

        if method in _IDEMPOTENT_METHODS:
            # 5xx bursts, timeouts and dropped connections retry in
            # place with capped-jittered backoff instead of surfacing
            # straight to the SDK/agent caller; the scattered ad-hoc
            # "except Exception: sleep and hope" sites this replaces
            # never distinguished transient from semantic failures.
            return retry_mod.with_retries(
                once, policy=retry_mod.CLIENT_POLICY,
                component="remote")
        return once()

    @staticmethod
    def _cls(kind: str):
        cls = WIRE_KINDS.get(kind)
        if cls is None:
            raise KeyError(f"unknown kind {kind!r}")
        return cls

    # -- CRUD (Store surface) ---------------------------------------------

    def create(self, kind: str, obj) -> object:
        data = self._request("POST", f"/apis/v1/{kind}", body=obj.to_dict())
        return self._cls(kind).from_dict(data)

    def get(self, kind: str, namespace: str, name: str) -> object:
        data = self._request("GET", f"/apis/v1/{kind}/{namespace}/{name}")
        return self._cls(kind).from_dict(data)

    def try_get(self, kind: str, namespace: str, name: str):
        try:
            return self.get(kind, namespace, name)
        except store_mod.NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             selector: Optional[Dict[str, str]] = None) -> List[object]:
        query: Dict[str, str] = {}
        if namespace is not None:
            query["namespace"] = namespace
        if selector:
            query["labelSelector"] = ",".join(
                f"{k}={v}" for k, v in sorted(selector.items()))
        data = self._request("GET", f"/apis/v1/{kind}", query=query)
        cls = self._cls(kind)
        return [cls.from_dict(item) for item in data.get("items", [])]

    def list_page(self, kind: str, namespace: Optional[str] = None,
                  selector: Optional[Dict[str, str]] = None,
                  limit: Optional[int] = None,
                  after: Optional[Tuple[str, str]] = None):
        """Store.list_page parity over the paginated list endpoint."""
        from tf_operator_tpu_torch.runtime.apiserver import (
            decode_continue,
            encode_continue,
        )

        query: Dict[str, str] = {}
        if namespace is not None:
            query["namespace"] = namespace
        if selector:
            query["labelSelector"] = ",".join(
                f"{k}={v}" for k, v in sorted(selector.items()))
        if limit is not None:
            query["limit"] = str(limit)
        if after is not None:
            query["continue"] = encode_continue(after)
        data = self._request("GET", f"/apis/v1/{kind}", query=query)
        cls = self._cls(kind)
        items = [cls.from_dict(item) for item in data.get("items", [])]
        cont = data.get("continue") or ""
        next_after = decode_continue(cont) if cont else None
        return items, next_after, data.get("resourceVersion", 0)

    def list_claimable(self, kind: str, namespace: str,
                       selector: Dict[str, str],
                       owner_uid: str) -> List[object]:
        """Store.list_claimable parity for duck-typed consumers: label
        match OR owned by ``owner_uid`` (client-side filter over the
        namespace listing)."""
        out = []
        for obj in self.list(kind, namespace=namespace):
            if not store_mod.matches_selector(obj.metadata.labels, selector):
                ref = obj.metadata.controller_ref()
                if ref is None or ref.uid != owner_uid:
                    continue
            out.append(obj)
        return out

    def update(self, kind: str, obj) -> object:
        meta = obj.metadata
        data = self._request(
            "PUT", f"/apis/v1/{kind}/{meta.namespace}/{meta.name}",
            body=obj.to_dict())
        return self._cls(kind).from_dict(data)

    def update_status(self, kind: str, obj) -> object:
        meta = obj.metadata
        data = self._request(
            "PUT", f"/apis/v1/{kind}/{meta.namespace}/{meta.name}/status",
            body=obj.to_dict())
        return self._cls(kind).from_dict(data)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._request("DELETE", f"/apis/v1/{kind}/{namespace}/{name}")

    def try_delete(self, kind: str, namespace: str, name: str) -> bool:
        try:
            self.delete(kind, namespace, name)
            return True
        except store_mod.NotFoundError:
            return False

    def count(self, kind: str) -> int:
        return len(self.list(kind))

    def keys(self, kind: str) -> List[Tuple[str, str, int]]:
        return [(o.metadata.namespace, o.metadata.name,
                 o.metadata.resource_version) for o in self.list(kind)]

    # -- watch -------------------------------------------------------------

    def watch(self, kind: str, handler: Callable[[str, object], None],
              replay: bool = True,
              since_rv: Optional[int] = None) -> RemoteWatcher:
        # On first connect the server replays current objects as ADDED
        # (or, with since_rv, only events newer than it); reconnects
        # resume from the last resourceVersion seen on the stream.
        self._cls(kind)
        w = RemoteWatcher(self.base_url, kind, handler,
                          token=self.token, ssl_context=self._ssl,
                          since_rv=since_rv)
        with self._lock:
            self._watchers.append(w)
        return w

    def stop_watchers(self) -> None:
        with self._lock:
            watchers, self._watchers = self._watchers, []
        for w in watchers:
            w.stop()

    # -- logs (API-server log proxy; not part of the in-process Store) ----

    def read_logs(self, namespace: str, pod_name: str,
                  tail_lines: Optional[int] = None) -> str:
        query: Dict[str, str] = {}
        if tail_lines is not None:
            query["tailLines"] = str(tail_lines)
        url = f"{self.base_url}/logs/{namespace}/{pod_name}"
        if query:
            url += "?" + urllib.parse.urlencode(query)
        try:
            with self._open(url, self.timeout) as resp:
                return resp.read().decode(errors="replace")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return ""
            raise

    def stream_logs(self, namespace: str, pod_name: str
                    ) -> Iterator[str]:
        """Follow a pod's log live (kubectl logs -f analog): yields chunks
        until the stream ends (pod finished and log drained). No socket
        timeout: a training pod can be quiet for minutes between lines;
        the server closes the stream when the pod terminates."""
        url = (f"{self.base_url}/logs/{namespace}/{pod_name}?follow=1")
        resp = self._open(url, None)
        try:
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    return
                yield chunk.decode(errors="replace")
        finally:
            resp.close()
