"""Parameter-server runtime: the async PS/Worker strategy (port of
train/ps.py).

A ``ps``-typed replica of a TPUJob needs a runtime behind it; this module
is the port's:

- ``python -m tf_operator_tpu_torch.train.ps`` is the ps container
  command. It reads its own task entry from ``TPUJOB_CLUSTER_SPEC``, binds
  that port and serves its shard of the parameters over HTTP (stdlib
  only), on the card unless ``--device cpu``.
- Parameters are sharded across ps replicas by a stable hash of the
  flattened parameter path (DownpourSGD-style). Each shard holds its
  parameters and SGD momentum trace as torch tensors on its device and
  applies pushed gradients asynchronously under a lock, with optax's
  ``sgd`` formula: trace = g + μ·trace, p ← p − lr·trace (no trace when
  μ = 0).
- Workers use :class:`PSClient`: ``init`` (first writer wins), ``pull``
  fresh params, ``push`` gradients.

The wire format is the JAX package's, byte for byte, so a JAX worker can
train against a port shard and the other way round: a dict[str, ndarray]
as an ``.npz`` payload with a ``__keys__`` manifest, keys '/'-joined paths
into the params tree, shards chosen by crc32 of the key. The state file
(``ps-shard-<i>.ckpt``) is the port's own: ``torch.save`` of the
parameters, the trace and the version, read back with
``weights_only=True``.

Threads: the HTTP handlers run on threads of their own. Every read or
write of the shard's tensors happens under the lock, and ``pull`` copies
them to the host there, so a handler never holds a device tensor that a
push is updating.
"""

from __future__ import annotations

import argparse
import hmac
import io
import json
import logging
import os
import signal
import threading
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tf_operator_tpu_torch._device import DeviceLike, resolve_device

log = logging.getLogger("tpu_operator.ps")

ENV_CLUSTER_SPEC = "TPUJOB_CLUSTER_SPEC"
# Shared-secret bearer token for the parameter API: inject the same value
# into ps and worker containers; unset = open (single-host/dev).
ENV_PS_TOKEN = "TPUJOB_PS_TOKEN"
# Directory for shard state persistence (a restarted shard resumes).
ENV_PS_STATE_DIR = "TPUJOB_PS_STATE_DIR"


# ---------------------------------------------------------------------------
# Tree <-> flat dict[str, ndarray] (the JAX package's wire format)
# ---------------------------------------------------------------------------

def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def flatten_params(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts of arrays or tensors -> {'a/b/c': ndarray}."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            out.update(flatten_params(v, key))
        return out
    out[prefix] = _host(tree)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> dict:
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def shard_of(key: str, num_shards: int) -> int:
    """Stable parameter->shard assignment (crc32: identical on every
    worker and server, unlike Python's salted hash())."""
    return zlib.crc32(key.encode()) % max(1, num_shards)


def _pack(flat: Dict[str, np.ndarray]) -> bytes:
    """Positional array names + a key manifest: user-controlled keys as
    np.savez kwargs would collide with its own parameters (a param path
    named 'file') and break on non-identifier characters."""
    keys = sorted(flat)
    buf = io.BytesIO()
    np.savez(buf, __keys__=np.array(keys),
             **{f"a{i}": np.asarray(flat[k]) for i, k in enumerate(keys)})
    return buf.getvalue()


def _unpack(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data)) as z:
        keys = [str(k) for k in z["__keys__"]]
        return {k: z[f"a{i}"] for i, k in enumerate(keys)}


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class ParameterServer:
    """One shard: holds its parameters (and momentum trace) on ``device``
    and applies pushed gradients asynchronously, first come first served,
    under a lock.

    ``lr``/``momentum``: optax ``sgd``'s (``momentum`` 0 keeps no trace).
    ``token``: require ``Authorization: Bearer <token>`` on every endpoint
    but /healthz. ``state_path``: persist (params, trace, version) there,
    atomically, every ``save_interval`` pushes and on ``stop()``, and
    restore at construction, so a restarted shard resumes."""

    def __init__(self, lr: float = 0.01, momentum: float = 0.0,
                 host: str = "", port: int = 0,
                 token: Optional[str] = None,
                 state_path: Optional[str] = None,
                 save_interval: int = 20, device: DeviceLike = None):
        self.lr = lr
        self.momentum = momentum
        self.device = resolve_device(device)
        self.token = token
        self.state_path = state_path
        self.save_interval = max(1, save_interval)
        self._lock = threading.Lock()
        self._params: Optional[Dict[str, torch.Tensor]] = None
        self._trace: Optional[Dict[str, torch.Tensor]] = None
        self._version = 0
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._host, self._port = host, port
        if state_path and os.path.exists(state_path):
            self._restore()

    # -- persistence ----------------------------------------------------

    def _persist_locked(self) -> None:
        """Write (params, trace, version) atomically and durably: fsync
        before the rename, so a crash leaves the old file or the new one,
        never a truncated one. Called under the lock. An IO error (disk
        full) must not poison the update already made: log, keep serving,
        retry at the next interval."""
        host = lambda d: None if d is None else {
            k: v.detach().cpu() for k, v in d.items()}
        try:
            tmp = self.state_path + ".tmp"
            with open(tmp, "wb") as f:
                torch.save({"params": host(self._params),
                            "trace": host(self._trace),
                            "version": self._version}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.state_path)
        except OSError:
            log.warning("persisting shard state to %s failed; state "
                        "stays in memory and the next interval retries",
                        self.state_path, exc_info=True)

    def _restore(self) -> None:
        """A corrupt or unreadable state file must not crashloop the pod:
        set it aside as ``.corrupt`` and start fresh (first-writer-wins
        init again; the trajectory is lost, the job heals)."""
        try:
            state = torch.load(self.state_path, map_location=self.device,
                               weights_only=True)
            params, trace = state["params"], state["trace"]
            version = int(state["version"])
            if not isinstance(params, dict) or not all(
                    isinstance(v, torch.Tensor) for v in params.values()):
                raise ValueError("state file holds no parameter tensors")
        except Exception:
            quarantine = self.state_path + ".corrupt"
            log.warning("shard state at %s unreadable; setting it aside "
                        "as %s and starting fresh", self.state_path,
                        quarantine, exc_info=True)
            try:
                os.replace(self.state_path, quarantine)
            except OSError:
                pass
            return
        self._params = params
        self._trace = trace if self.momentum else None
        if self.momentum and self._trace is None:
            self._trace = {k: torch.zeros_like(v) for k, v in params.items()}
        self._version = version
        log.info("restored shard state from %s (version %d, %d params)",
                 self.state_path, self._version, len(self._params))

    def save_now(self) -> None:
        if not self.state_path:
            return
        with self._lock:
            if self._params is not None:
                self._persist_locked()

    # -- state ops (thread-safe) ---------------------------------------

    def init(self, flat: Dict[str, np.ndarray]) -> bool:
        """First writer wins (workers race to initialize; a restored
        shard keeps its state); returns whether this call installed the
        parameters."""
        with self._lock:
            if self._params is not None:
                return False
            self._params = {k: torch.tensor(np.asarray(v),
                                            device=self.device)
                            for k, v in flat.items()}
            if self.momentum:
                self._trace = {k: torch.zeros_like(v)
                               for k, v in self._params.items()}
            if self.state_path:
                self._persist_locked()
            return True

    def pull(self) -> Tuple[Dict[str, np.ndarray], int]:
        """Host copies of the parameters, and the version."""
        with self._lock:
            if self._params is None:
                raise KeyError("parameters not initialized")
            return ({k: v.to("cpu", copy=True).numpy()
                     for k, v in self._params.items()}, self._version)

    def push(self, grads: Dict[str, np.ndarray]) -> int:
        """Apply one async gradient update; returns the new version.
        Gradients are cast to each parameter's dtype; keys the shard does
        not hold are ignored, one it holds missing is a ValueError. The
        update is all or nothing, as the JAX server's: every gradient is
        converted and checked against its parameter (a TypeError where
        its shape does not broadcast to the parameter's) before any
        parameter or trace moves."""
        with self._lock:
            if self._params is None:
                raise KeyError("parameters not initialized")
            missing = set(self._params) - set(grads)
            if missing:
                raise ValueError(f"push missing keys: {sorted(missing)[:3]}")
            converted = {}
            for k, p in self._params.items():
                g = torch.tensor(np.asarray(grads[k]), dtype=p.dtype,
                                 device=self.device)
                try:
                    fits = torch.broadcast_shapes(g.shape, p.shape) == p.shape
                except RuntimeError:
                    fits = False
                if not fits:
                    raise TypeError(f"push gradient {k!r} of shape "
                                    f"{tuple(g.shape)} does not fit its "
                                    f"parameter's {tuple(p.shape)}")
                converted[k] = g
            for k, p in self._params.items():
                g = converted[k]
                if self._trace is not None:
                    g = self._trace[k].mul_(self.momentum).add_(g)
                # optax: updates = -lr * g; apply_updates: p + updates.
                p.add_(g * -self.lr)
            self._version += 1
            if self.state_path and self._version % self.save_interval == 0:
                self._persist_locked()
            return self._version

    # -- HTTP ----------------------------------------------------------

    def serve(self) -> "ParameterServer":
        ps = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                log.debug("ps http: " + fmt, *args)

            def _authorized(self) -> bool:
                """Shared-secret gate on every endpoint but /healthz."""
                if ps.token is None or self.path == "/healthz":
                    return True
                auth = self.headers.get("Authorization", "")
                return (auth.startswith("Bearer ")
                        and hmac.compare_digest(auth[7:], ps.token))

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length", "0"))
                return self.rfile.read(n)

            def _send(self, code: int, data: bytes = b"",
                      ctype: str = "application/octet-stream",
                      headers: Optional[Dict[str, str]] = None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    return self._send(200, b"ok", "text/plain")
                if not self._authorized():
                    return self._send(401, b"unauthorized", "text/plain")
                if self.path == "/params":
                    try:
                        flat, version = ps.pull()
                    except KeyError:
                        return self._send(409, b"uninitialized",
                                          "text/plain")
                    return self._send(200, _pack(flat), headers={
                        "X-PS-Version": str(version)})
                self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if not self._authorized():
                    self._body()  # keep-alive hygiene: consume first
                    return self._send(401, b"unauthorized", "text/plain")
                if self.path == "/init":
                    installed = ps.init(_unpack(self._body()))
                    return self._send(200 if installed else 208,
                                      b"ok", "text/plain")
                if self.path == "/push":
                    try:
                        version = ps.push(_unpack(self._body()))
                    except KeyError:
                        return self._send(409, b"uninitialized",
                                          "text/plain")
                    except ValueError as e:
                        return self._send(400, str(e).encode(),
                                          "text/plain")
                    return self._send(200, str(version).encode(),
                                      "text/plain")
                self._send(404, b"not found", "text/plain")

        self._httpd = ThreadingHTTPServer((self._host or "", self._port),
                                          Handler)
        self._port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         name="ps-http", daemon=True).start()
        return self

    @property
    def port(self) -> int:
        return self._port

    def stop(self) -> None:
        self.save_now()  # final state flush (SIGTERM path)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()


# ---------------------------------------------------------------------------
# Worker-side client
# ---------------------------------------------------------------------------

class PSClient:
    """Worker handle on the sharded parameter servers.

    - ``token`` rides every request as a bearer credential (default
      ``$TPUJOB_PS_TOKEN``, the env the server reads).
    - Transport failures retry with backoff for ``retry_seconds``: a ps
      pod restarting mid-training makes workers wait instead of crash. A
      retried /push may land a gradient twice, which async training
      tolerates as it tolerates staleness.
    - Multi-shard pull/push fan out concurrently, one thread per shard,
      on a persistent pool: the wire time is the slowest shard's.
    """

    def __init__(self, addrs: List[str], timeout: float = 30.0,
                 token: Optional[str] = None,
                 retry_seconds: float = 60.0):
        if not addrs:
            raise ValueError("no parameter-server addresses")
        self.addrs = list(addrs)
        self.timeout = timeout
        self.token = (token if token is not None
                      else os.environ.get(ENV_PS_TOKEN) or None)
        self.retry_seconds = retry_seconds
        self._pool: Optional[ThreadPoolExecutor] = None

    def _open_once(self, addr: str, path: str,
                   data: Optional[bytes] = None,
                   timeout: Optional[float] = None):
        """One request attempt, no retry (``wait_ready``'s poll loop owns
        its deadline and must see failures at once)."""
        req = urllib.request.Request(
            f"http://{addr}{path}", data=data,
            method="POST" if data is not None else "GET")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        return urllib.request.urlopen(
            req, timeout=self.timeout if timeout is None else timeout)

    def _req(self, addr: str, path: str, data: Optional[bytes] = None):
        deadline = time.monotonic() + self.retry_seconds
        delay = 0.1
        while True:
            try:
                return self._open_once(addr, path, data)
            except urllib.error.HTTPError:
                raise  # the server answered: 4xx is no transport blip
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 2.0)

    def _fan_out(self, calls) -> list:
        """Run (fn, *args) tuples concurrently, one thread per shard;
        re-raises the first failure."""
        if len(calls) == 1:
            fn, *args = calls[0]
            return [fn(*args)]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=len(self.addrs),
                                            thread_name_prefix="ps-client")
        futures = [self._pool.submit(fn, *args) for fn, *args in calls]
        return [f.result() for f in futures]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def _partition(self, flat: Dict[str, np.ndarray]
                   ) -> List[Dict[str, np.ndarray]]:
        parts: List[Dict[str, np.ndarray]] = [
            {} for _ in range(len(self.addrs))]
        for k, v in flat.items():
            parts[shard_of(k, len(self.addrs))][k] = np.asarray(v)
        return parts

    def init(self, params) -> None:
        """Race-safe global init: every shard keeps its first writer."""

        def one(addr, part):
            with self._req(addr, "/init", _pack(part)) as resp:
                resp.read()

        self._fan_out([(one, addr, part) for addr, part in zip(
            self.addrs, self._partition(flatten_params(params)))])

    def pull(self) -> dict:
        """The whole parameter tree (numpy leaves)."""

        def one(addr):
            with self._req(addr, "/params") as resp:
                return _unpack(resp.read())

        flat: Dict[str, np.ndarray] = {}
        for part in self._fan_out([(one, a) for a in self.addrs]):
            flat.update(part)
        return unflatten_params(flat)

    def push(self, grads) -> None:
        """Gradients (a tree of arrays or tensors) to their shards."""

        def one(addr, part):
            with self._req(addr, "/push", _pack(part)) as resp:
                resp.read()

        calls = [(one, addr, part) for addr, part in zip(
            self.addrs, self._partition(flatten_params(grads))) if part]
        if calls:
            self._fan_out(calls)

    def wait_ready(self, timeout: float = 60.0) -> None:
        """Poll /healthz on every shard until ready or ``timeout``, on the
        non-retrying path (``_req``'s retry window would stretch each
        probe past this deadline)."""
        deadline = time.monotonic() + timeout
        for addr in self.addrs:
            while True:
                try:
                    with self._open_once(addr, "/healthz",
                                         timeout=2.0) as resp:
                        if resp.status == 200:
                            break
                except OSError:
                    pass
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"ps {addr} never became ready")
                time.sleep(0.1)


# ---------------------------------------------------------------------------
# Cluster-spec plumbing + process entrypoint
# ---------------------------------------------------------------------------

def cluster_ps_addrs(spec_json: Optional[str] = None) -> List[str]:
    """ps 'host:port' list from TPUJOB_CLUSTER_SPEC (operator-injected;
    the local backend's resolver rewrites hosts to reachable ones)."""
    raw = spec_json if spec_json is not None else os.environ.get(
        ENV_CLUSTER_SPEC, "")
    if not raw:
        return []
    return list((json.loads(raw).get("cluster") or {}).get("ps") or [])


def own_task(spec_json: Optional[str] = None) -> Tuple[str, int]:
    raw = spec_json if spec_json is not None else os.environ.get(
        ENV_CLUSTER_SPEC, "")
    task = (json.loads(raw).get("task") or {}) if raw else {}
    return task.get("type", ""), int(task.get("index", 0))


def main(argv=None) -> int:
    """The ps container command: serve this task's parameter shard until
    terminated (job completion reaps ps pods via CleanPodPolicy)."""
    ap = argparse.ArgumentParser(prog="tpu-operator-ps")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--momentum", type=float, default=0.0)
    ap.add_argument("--state-dir", default=None,
                    help="persist shard state here (restart-safe; "
                         "default $TPUJOB_PS_STATE_DIR; unset = "
                         "in-memory only)")
    ap.add_argument("--save-interval", type=int, default=20,
                    help="persist every N pushes (with --state-dir)")
    ap.add_argument("--device", default=None,
                    help="torch device of the shard (default: the card)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    ttype, index = own_task()
    if ttype != "ps":
        raise SystemExit(f"task type is {ttype!r}, not 'ps' "
                         f"(is {ENV_CLUSTER_SPEC} set?)")
    device = resolve_device(args.device)
    addrs = cluster_ps_addrs()
    own = addrs[index] if index < len(addrs) else ":0"
    host, _, port_s = own.rpartition(":")
    port = int(port_s or 0)
    # Bind loopback when that is where peers dial (single-host resolver):
    # an all-interfaces bind would expose the parameter API to the
    # network. Non-loopback entries (kube pod DNS) need all interfaces.
    bind_host = "127.0.0.1" if host.startswith("127.") else ""
    state_dir = args.state_dir or os.environ.get(ENV_PS_STATE_DIR) or None
    state_path = None
    if state_dir:
        os.makedirs(state_dir, exist_ok=True)
        state_path = os.path.join(state_dir, f"ps-shard-{index}.ckpt")
    server = ParameterServer(lr=args.lr, momentum=args.momentum,
                             host=bind_host, port=port,
                             token=os.environ.get(ENV_PS_TOKEN) or None,
                             state_path=state_path,
                             save_interval=args.save_interval,
                             device=device).serve()
    log.info("parameter server shard %d serving on :%d on %s%s%s", index,
             server.port, device,
             " (auth on)" if server.token else "",
             f" (state: {state_path})" if state_path else "")

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
