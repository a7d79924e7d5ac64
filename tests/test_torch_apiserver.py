"""The port's served plane against the JAX package's, in one process.

- The port's API server, remote store, node agent, TLS bootstrap and
  token file, case by case as ``tests/test_apiserver.py`` holds the JAX
  ones (real HTTP over loopback, no fakes);
- the wire: one request sequence (create, get, a label selector, a
  two-page list, update, the status subresource, a conflict, a
  delete, a watch resumed from a resourceVersion, the error bodies)
  sent raw to both servers gives equal status codes and JSON bodies
  once uids, timestamps and resourceVersions are masked; the same
  sequence through each package's ``RemoteStore`` against each
  package's ``APIServer`` gives one transcript in all four pairings;
  and a job file submitted through either client reads back the same;
- the resolution: a pod env rendered by each package goes through each
  package's resolver over the same placements: the port's
  ``MASTER_ADDR:MASTER_PORT`` is the JAX ``JAX_COORDINATOR_ADDRESS``,
  the ps cluster spec is byte-equal, and the timeout and the missing
  coordinator port raise as in JAX.
"""

import http.client
import json
import os
import stat
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from tf_operator_tpu import testutil as jtestutil
from tf_operator_tpu.bootstrap import render_worker_env as j_render
from tf_operator_tpu.runtime import agent as jagent
from tf_operator_tpu.runtime import apiserver as japiserver
from tf_operator_tpu.runtime import remote as jremote
from tf_operator_tpu.runtime import store as jstore
from tf_operator_tpu.runtime import tlsutil as jtlsutil
from tf_operator_tpu_torch import testutil
from tf_operator_tpu_torch.api.types import (
    Container,
    JobConditionType,
    ObjectMeta,
    Pod,
    PodPhase,
    PodSpec,
    PodStatus,
)
from tf_operator_tpu_torch.bootstrap import render_worker_env as t_render
from tf_operator_tpu_torch.controller import conditions as cond
from tf_operator_tpu_torch.runtime import agent as tagent
from tf_operator_tpu_torch.runtime import apiserver as tapiserver
from tf_operator_tpu_torch.runtime import remote as tremote
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime import tlsutil
from tf_operator_tpu_torch.runtime.agent import (
    ControlPlaneEnvResolver,
    NodeAgent,
)
from tf_operator_tpu_torch.runtime.apiserver import (
    APIServer,
    parse_label_selector,
    wait_for_server,
)
from tf_operator_tpu_torch.runtime.remote import RemoteStore
from tf_operator_tpu_torch.runtime.store import Store
from tf_operator_tpu_torch.sdk import TPUJobClient

pytestmark = pytest.mark.control_plane

# package -> (store module, apiserver module, remote module, testutil)
PACKAGES = {"jax": (jstore, japiserver, jremote, jtestutil),
            "torch": (store_mod, tapiserver, tremote, testutil)}


@pytest.fixture(autouse=True)
def quick_keepalives(monkeypatch):
    """Watch keepalives every 0.2 s: a stopped watcher's stream ends at
    the next keepalive, so a test does not wait 3 s for each."""
    for _, amod, _, _ in PACKAGES.values():
        monkeypatch.setattr(amod, "_WATCH_KEEPALIVE_SECONDS", 0.2)


@pytest.fixture
def served():
    store = Store()
    server = APIServer(store, port=0).start()
    wait_for_server(server.url)
    remote = RemoteStore(server.url)
    yield store, remote
    remote.stop_watchers()
    server.stop()
    store.stop_watchers()


def wait_for(predicate, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


# ---------------------------------------------------------------------------
# The port's server, client and agent (tests/test_apiserver.py's cases)
# ---------------------------------------------------------------------------

def test_crud_roundtrip(served):
    store, remote = served
    created = remote.create(store_mod.TPUJOBS,
                            testutil.new_tpujob(worker=2, name="rt"))
    assert created.metadata.uid and created.metadata.resource_version > 0
    got = remote.get(store_mod.TPUJOBS, "default", "rt")
    got.spec.replica_specs["worker"].replicas = 3
    assert remote.update(store_mod.TPUJOBS,
                         got).spec.replica_specs["worker"].replicas == 3
    assert store.get(store_mod.TPUJOBS, "default",
                     "rt").spec.replica_specs["worker"].replicas == 3
    remote.delete(store_mod.TPUJOBS, "default", "rt")
    assert remote.try_get(store_mod.TPUJOBS, "default", "rt") is None


def test_error_mapping(served):
    _, remote = served
    with pytest.raises(store_mod.NotFoundError):
        remote.get(store_mod.TPUJOBS, "default", "missing")
    assert remote.try_delete(store_mod.TPUJOBS, "default", "missing") is False
    remote.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=1, name="d"))
    with pytest.raises(store_mod.AlreadyExistsError):
        remote.create(store_mod.TPUJOBS,
                      testutil.new_tpujob(worker=1, name="d"))
    fresh = remote.get(store_mod.TPUJOBS, "default", "d")
    remote.update(store_mod.TPUJOBS, fresh)
    with pytest.raises(store_mod.ConflictError):
        remote.update(store_mod.TPUJOBS, fresh)
    with pytest.raises(KeyError):
        remote.get("nonsense", "default", "x")


def test_list_namespace_and_selector(served):
    _, remote = served
    for ns, name, color in (("a", "j1", "red"), ("a", "j2", "blue"),
                            ("b", "j3", "red")):
        job = testutil.new_tpujob(worker=1, name=name, namespace=ns)
        job.metadata.labels["color"] = color
        remote.create(store_mod.TPUJOBS, job)
    assert len(remote.list(store_mod.TPUJOBS)) == 3
    assert len(remote.list(store_mod.TPUJOBS, namespace="a")) == 2
    reds = remote.list(store_mod.TPUJOBS, selector={"color": "red"})
    assert sorted(j.metadata.name for j in reds) == ["j1", "j3"]
    assert remote.count(store_mod.TPUJOBS) == 3
    assert len(remote.keys(store_mod.TPUJOBS)) == 3


def test_status_subresource_does_not_clobber_spec(served):
    _, remote = served
    remote.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=1, name="st"))
    stale = remote.get(store_mod.TPUJOBS, "default", "st")
    fresh = remote.get(store_mod.TPUJOBS, "default", "st")
    fresh.spec.replica_specs["worker"].replicas = 5
    remote.update(store_mod.TPUJOBS, fresh)
    cond.update_job_conditions(stale.status, JobConditionType.CREATED,
                               "Test", "created")
    remote.update_status(store_mod.TPUJOBS, stale)
    final = remote.get(store_mod.TPUJOBS, "default", "st")
    assert final.spec.replica_specs["worker"].replicas == 5
    assert final.status.conditions[0].type == JobConditionType.CREATED


def test_watch_replays_and_streams(served):
    _, remote = served
    remote.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=1,
                                                         name="pre"))
    seen = []
    watcher = remote.watch(store_mod.TPUJOBS,
                           lambda et, obj: seen.append((et,
                                                        obj.metadata.name)))
    assert wait_for(lambda: ("ADDED", "pre") in seen, 5)
    remote.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=1,
                                                         name="live"))
    remote.delete(store_mod.TPUJOBS, "default", "live")
    assert wait_for(lambda: ("DELETED", "live") in seen, 5)
    assert ("ADDED", "live") in seen
    watcher.stop()


def test_list_pagination_exactly_once_under_concurrent_writes(served):
    _, remote = served
    for i in range(10):
        remote.create(store_mod.TPUJOBS,
                      testutil.new_tpujob(worker=1, name=f"pg-{i:02d}"))
    seen, after, page = [], None, 0
    while True:
        items, after, rv = remote.list_page(store_mod.TPUJOBS,
                                            namespace="default", limit=3,
                                            after=after)
        assert isinstance(rv, int) and rv > 0
        seen.extend(o.metadata.name for o in items)
        if after is None:
            break
        remote.update(store_mod.TPUJOBS,
                      remote.get(store_mod.TPUJOBS, "default", seen[0]))
        remote.create(store_mod.TPUJOBS, testutil.new_tpujob(
            worker=1, name=f"aa-new-{page}"))
        page += 1
    assert len(seen) == len(set(seen))
    assert {f"pg-{i:02d}" for i in range(10)} <= set(seen)


@pytest.mark.parametrize("query", ["limit=0", "limit=x",
                                   "continue=!!!not-base64!!!",
                                   "labelSelector=nonsense"])
def test_list_bad_query_is_400(served, query):
    _, remote = served
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"{remote.base_url}/apis/v1/tpujobs?{query}",
                               timeout=5)
    assert err.value.code == 400


def test_watch_reconnect_resumes_without_added_storm(served):
    _, remote = served
    for i in range(4):
        remote.create(store_mod.TPUJOBS,
                      testutil.new_tpujob(worker=1, name=f"w-{i}"))
    seen, lock = [], threading.Lock()

    def handler(et, obj):
        with lock:
            seen.append((et, obj.metadata.name))

    watcher = remote.watch(store_mod.TPUJOBS, handler)
    assert wait_for(lambda: len(seen) >= 4, 5)
    with watcher._lock:
        watcher._resp.close()
    remote.create(store_mod.TPUJOBS,
                  testutil.new_tpujob(worker=1, name="post-drop"))
    assert wait_for(lambda: any(n == "post-drop" for _, n in seen), 10)
    watcher.stop()
    names = [n for _, n in seen]
    assert all(names.count(f"w-{i}") == 1 for i in range(4)), names


def test_parse_label_selector():
    assert parse_label_selector("a=b, c = d ,") == {"a": "b", "c": "d"}
    with pytest.raises(ValueError):
        parse_label_selector("nonsense")


def test_resolver_rewrites_the_rendezvous_to_rank_0(served):
    """MASTER_ADDR names rank 0's pod: both MASTER_ keys become that
    pod's published host and coordinator port, also for another rank's
    pod; other keys pass through."""
    store, remote = served
    for i, (host, port) in enumerate((("10.2.3.4", 43999),
                                      ("10.2.3.5", 44001))):
        store.create(store_mod.PODS, Pod(
            metadata=ObjectMeta(name=f"j-worker-{i}", namespace="ns1"),
            status=PodStatus(host=host, ports={"coordinator": port})))
    peer = store.get(store_mod.PODS, "ns1", "j-worker-1")
    out = ControlPlaneEnvResolver(remote, timeout=5).resolve(peer, {
        "MASTER_ADDR": "j-worker-0.ns1.svc", "MASTER_PORT": "8476",
        "RANK": "1", "OTHER": "untouched"})
    assert out == {"MASTER_ADDR": "10.2.3.4", "MASTER_PORT": "43999",
                   "RANK": "1", "OTHER": "untouched"}


def test_resolver_ps_cluster_spec(served):
    store, remote = served
    for i, (host, port) in enumerate((("10.9.0.1", 45001),
                                      ("10.9.0.2", 45002))):
        store.create(store_mod.PODS, Pod(
            metadata=ObjectMeta(name=f"j-ps-{i}", namespace="ns1"),
            status=PodStatus(host=host, ports={"coordinator": port})))
    worker = Pod(metadata=ObjectMeta(name="j-worker-0", namespace="ns1"))
    spec = json.dumps({
        "cluster": {"ps": ["j-ps-0.ns1.svc:2222", "j-ps-1.ns1.svc:2222"],
                    "worker": ["j-worker-0.ns1.svc:2222"]},
        "task": {"type": "worker", "index": 0}})
    out = ControlPlaneEnvResolver(remote, timeout=5).resolve(
        worker, {"TPUJOB_CLUSTER_SPEC": spec})
    resolved = json.loads(out["TPUJOB_CLUSTER_SPEC"])
    assert resolved["cluster"] == {
        "ps": ["10.9.0.1:45001", "10.9.0.2:45002"],
        "worker": ["j-worker-0.ns1.svc:2222"]}
    no_ps = json.dumps({"cluster": {"worker": ["w0.ns1.svc:2222"]},
                        "task": {"type": "worker", "index": 0}})
    assert ControlPlaneEnvResolver(remote, timeout=1).resolve(
        worker, {"TPUJOB_CLUSTER_SPEC": no_ps}) == {
            "TPUJOB_CLUSTER_SPEC": no_ps}
    assert ControlPlaneEnvResolver(remote, timeout=1).resolve(
        worker, {"TPUJOB_CLUSTER_SPEC": "not-json"}) == {
            "TPUJOB_CLUSTER_SPEC": "not-json"}


def test_agent_claims_and_runs_pod(served, tmp_path):
    """The kubelet loop against the served plane: the agent registers
    its node with its GPUs, claims an unbound pod, publishes its
    placement, runs it on the cards of its ``nvidia.com/gpu`` request
    (the first two of the node's eight), and its log comes through the
    proxy."""
    store, remote = served
    agent = NodeAgent(remote.base_url, name="n1", address="127.0.0.1",
                      chips=8, workdir=str(tmp_path)).start()
    try:
        node = store.get(store_mod.NODES, "default", "n1")
        assert node.status.log_url.startswith("http://127.0.0.1:")
        assert node.spec.chips == 8
        remote.create(store_mod.PODS, Pod(
            metadata=ObjectMeta(name="hello"),
            spec=PodSpec(containers=[Container(command=[
                sys.executable, "-c",
                "import os; print('hi from pod', "
                "os.environ.get('CUDA_VISIBLE_DEVICES'))"],
                resources={"nvidia.com/gpu": "2"})])))
        assert wait_for(lambda: store.get(
            store_mod.PODS, "default", "hello").status.phase
            == PodPhase.SUCCEEDED, 20)
        got = store.get(store_mod.PODS, "default", "hello")
        assert (got.spec.node_name, got.status.host) == ("n1", "127.0.0.1")
        assert got.status.ports.get("coordinator")
        want = os.environ.get("CUDA_VISIBLE_DEVICES") or "0,1,2,3,4,5,6,7"
        want = ",".join(want.split(",")[:2])
        assert f"hi from pod {want}" in remote.read_logs("default", "hello")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(
                f"http://127.0.0.1:{agent._log_httpd.server_address[1]}"
                "/logs/default/hello", timeout=5)
        assert err.value.code == 404
        assert agent.log_secret in agent.log_url
    finally:
        agent.stop()


class TestAuthAndTls:
    TOKENS = {"admin-secret": "admin", "viewer-secret": "read-only"}

    @pytest.fixture
    def authed(self):
        store = Store()
        server = APIServer(store, port=0, tokens=self.TOKENS).start()
        wait_for_server(server.url)
        yield store, server
        server.stop()
        store.stop_watchers()

    @pytest.mark.parametrize("token", [None, "wrong", "admin-secre",
                                       "admin-secret2", "ADMIN-SECRET"])
    def test_missing_or_bad_token_401(self, authed, token):
        _, server = authed
        remote = RemoteStore(server.url, token=token)
        with pytest.raises(RuntimeError, match="401"):
            remote.list(store_mod.TPUJOBS)
        with pytest.raises(RuntimeError, match="401"):
            remote.create(store_mod.TPUJOBS,
                          testutil.new_tpujob(worker=1, name="nope"))

    def test_admin_writes_read_only_reads(self, authed):
        store, server = authed
        admin = RemoteStore(server.url, token="admin-secret")
        admin.create(store_mod.TPUJOBS,
                     testutil.new_tpujob(worker=1, name="aj"))
        viewer = RemoteStore(server.url, token="viewer-secret")
        assert viewer.get(store_mod.TPUJOBS, "default", "aj")
        assert len(viewer.list(store_mod.TPUJOBS)) == 1
        with pytest.raises(RuntimeError, match="403"):
            viewer.create(store_mod.TPUJOBS,
                          testutil.new_tpujob(worker=1, name="ro2"))
        with pytest.raises(RuntimeError, match="403"):
            viewer.delete(store_mod.TPUJOBS, "default", "aj")
        seen = threading.Event()
        w = viewer.watch(store_mod.TPUJOBS, lambda *a: seen.set())
        try:
            assert seen.wait(10), "authed watch never delivered"
        finally:
            w.stop()
        admin.delete(store_mod.TPUJOBS, "default", "aj")
        assert store.try_get(store_mod.TPUJOBS, "default", "aj") is None

    def test_keepalive_connection_survives_rejected_write(self, authed):
        _, server = authed
        host, port = server.url.replace("http://", "").split(":")
        conn = http.client.HTTPConnection(host, int(port))
        try:
            conn.request("POST", "/apis/v1/tpujobs",
                         body=json.dumps({"metadata": {"name": "x"}}),
                         headers={"Authorization": "Bearer viewer-secret",
                                  "Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 403
            resp.read()
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            assert resp.status == 200 and b"ok" in resp.read()
        finally:
            conn.close()

    @pytest.mark.parametrize("host,insecure,open_", [
        ("0.0.0.0", False, False), ("", False, False),
        ("0.0.0.0", True, True)])
    def test_non_loopback_bind_fails_closed(self, host, insecure, open_):
        store = Store()
        server = APIServer(store, host=host, port=0,
                           insecure=insecure).start()
        try:
            url = f"http://127.0.0.1:{server.port}"
            wait_for_server(url)
            remote = RemoteStore(url)
            if open_:
                assert remote.list(store_mod.TPUJOBS) == []
            else:
                with pytest.raises(RuntimeError, match="401"):
                    remote.list(store_mod.TPUJOBS)
        finally:
            server.stop()
            store.stop_watchers()

    def test_loopback_host_classifier(self):
        for host in ("localhost", "127.0.0.1", "::1", "", "::", "0.0.0.0",
                     "10.0.0.5", "example.com"):
            assert tapiserver._is_loopback_host(host) == \
                japiserver._is_loopback_host(host), host
        assert tapiserver._is_loopback_host("::1")
        assert not tapiserver._is_loopback_host("")


class TestTls:
    @pytest.fixture
    def tls_files(self, tmp_path):
        cert, key = str(tmp_path / "cert.pem"), str(tmp_path / "key.pem")
        tlsutil.ensure_self_signed(cert, key)
        return cert, key

    def test_key_file_is_0600_and_bootstrap_idempotent(self, tls_files):
        cert, key = tls_files
        assert stat.S_IMODE(os.stat(key).st_mode) == 0o600
        before = open(cert).read()
        tlsutil.ensure_self_signed(cert, key)
        assert open(cert).read() == before

    def test_tls_roundtrip_with_auth(self, tls_files):
        cert, key = tls_files
        store = Store()
        server = APIServer(store, port=0, tls_cert=cert, tls_key=key,
                           tokens={"t": "admin"}).start()
        try:
            assert server.url.startswith("https://")
            wait_for_server(server.url, ca_file=cert)
            remote = RemoteStore(server.url, token="t", ca_file=cert)
            remote.create(store_mod.TPUJOBS,
                          testutil.new_tpujob(worker=1, name="tj"))
            assert remote.get(store_mod.TPUJOBS, "default", "tj")
            ev = threading.Event()
            w = remote.watch(store_mod.TPUJOBS, lambda *a: ev.set())
            try:
                assert ev.wait(10)
            finally:
                w.stop()
            with pytest.raises((OSError, urllib.error.URLError)):
                RemoteStore(server.url, token="t").list(store_mod.TPUJOBS)
            assert RemoteStore(server.url, token="t",
                               insecure_skip_verify=True).list(
                store_mod.TPUJOBS)
        finally:
            server.stop()
            store.stop_watchers()


@pytest.mark.parametrize("text,want", [
    ("# ops\nadmintok admin\n\nviewtok read-only\ndefaulttok\n",
     {"admintok": "admin", "viewtok": "read-only", "defaulttok": "admin"}),
    ("tok superuser\n", "unknown role"),
    ("tok\ntok read-only\n", "duplicate"),
    ("# nothing\n", "no tokens"),
])
def test_load_tokens_as_jax(tmp_path, text, want):
    path = tmp_path / "tokens"
    path.write_text(text)
    if isinstance(want, dict):
        assert tlsutil.load_tokens(str(path)) == want == \
            jtlsutil.load_tokens(str(path))
        return
    with pytest.raises(ValueError, match=want) as got:
        tlsutil.load_tokens(str(path))
    with pytest.raises(ValueError) as jgot:
        jtlsutil.load_tokens(str(path))
    assert str(got.value) == str(jgot.value)


def test_read_token_skips_blanks_and_comments(tmp_path):
    path = tmp_path / "tokens"
    path.write_text("\n# operator tokens\n\nadmintok admin\n")
    assert tlsutil.read_token(str(path)) == "admintok"
    empty = tmp_path / "none"
    empty.write_text("# nothing\n\n")
    with pytest.raises(ValueError, match="no token"):
        tlsutil.read_token(str(empty))
    assert (tlsutil.ROLE_ADMIN, tlsutil.ROLE_READ_ONLY) == (
        jtlsutil.ROLE_ADMIN, jtlsutil.ROLE_READ_ONLY)


# ---------------------------------------------------------------------------
# The same wire as the JAX package's
# ---------------------------------------------------------------------------

_MASKED = ("uid", "resourceVersion")


def mask(value):
    """uids, resourceVersions and timestamps replaced by a mark."""
    if isinstance(value, dict):
        return {k: ("<masked>" if (k in _MASKED or k.endswith("Time")
                                   or k.endswith("Timestamp"))
                    and v not in (None, "", 0) else mask(v))
                for k, v in value.items()}
    if isinstance(value, list):
        return [mask(v) for v in value]
    return value


@pytest.fixture
def both_servers():
    """{package: (store, server)}, each package's own store and server."""
    out = {}
    for name, (smod, amod, _, _) in PACKAGES.items():
        store = smod.Store()
        out[name] = (store, amod.APIServer(store, port=0).start())
    for _, server in out.values():
        wait_for_server(server.url)
    yield out
    for store, server in out.values():
        server.stop()
        store.stop_watchers()


def call(url: str, method: str, path: str, body=None, raw: bytes = None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def watch_replay(url: str, since_rv: int) -> list:
    """The events a watch resumed after ``since_rv`` replays, up to the
    scenario's last one, the DELETED of its delete (keepalives skipped:
    the store replays on its watcher's thread, which a loaded host may
    run after a keepalive)."""
    events = []
    with urllib.request.urlopen(
            f"{url}/apis/v1/watch/tpujobs?resourceVersion={since_rv}",
            timeout=10) as resp:
        for line in resp:
            if line.strip():
                events.append(json.loads(line))
                if events[-1]["type"] == "DELETED":
                    break
    return events


def wire_scenario(url: str, tu) -> list:
    """One request sequence over raw HTTP; returns (step, code, masked
    body) for every response."""
    out = []

    def step(name, method, path, body=None, raw=None):
        code, payload = call(url, method, path, body, raw)
        out.append((name, code, mask(payload)))
        return payload

    for ns, name, color in (("a", "j1", "red"), ("a", "j2", "blue"),
                            ("b", "j3", "red"), ("a", "j4", "red")):
        job = tu.new_tpujob(worker=2, name=name, namespace=ns)
        job.metadata.labels["color"] = color
        step(f"create {name}", "POST", "/apis/v1/tpujobs", job.to_dict())
    j1 = step("get", "GET", "/apis/v1/tpujobs/a/j1")
    step("selector", "GET", "/apis/v1/tpujobs?labelSelector=color%3Dred")
    page = step("page 1", "GET", "/apis/v1/tpujobs?namespace=a&limit=2")
    step("page 2", "GET", "/apis/v1/tpujobs?namespace=a&limit=2&continue="
         + page["continue"])
    j1["spec"]["replicaSpecs"]["worker"]["replicas"] = 3
    updated = step("update", "PUT", "/apis/v1/tpujobs/a/j1", j1)
    since = updated["metadata"]["resourceVersion"]
    updated["status"] = {"conditions": [{
        "type": "Created", "status": "True", "reason": "Test",
        "message": "created"}]}
    step("status", "PUT", "/apis/v1/tpujobs/a/j1/status", updated)
    step("conflict", "PUT", "/apis/v1/tpujobs/a/j1", j1)
    step("exists", "POST", "/apis/v1/tpujobs", j1)
    step("no name", "POST", "/apis/v1/tpujobs", {"metadata": {}})
    step("bad json", "POST", "/apis/v1/tpujobs", raw=b"{nope")
    step("not found", "GET", "/apis/v1/tpujobs/a/missing")
    step("unknown kind", "GET", "/apis/v1/nonsense")
    step("no route", "GET", "/apis/v2/tpujobs")
    step("bad subresource", "PUT", "/apis/v1/tpujobs/a/j1/scale", j1)
    step("delete", "DELETE", "/apis/v1/tpujobs/a/j2")
    step("delete again", "DELETE", "/apis/v1/tpujobs/a/j2")
    step("healthz", "GET", "/healthz")
    out.append(("watch", 200, mask(watch_replay(url, since))))
    return out


def test_wire_bodies_and_codes_equal_jax(both_servers):
    got = {name: wire_scenario(server.url, PACKAGES[name][3])
           for name, (_, server) in both_servers.items()}
    assert [s[0] for s in got["torch"]] == [s[0] for s in got["jax"]]
    for want, have in zip(got["jax"], got["torch"]):
        assert have == want, want[0]
    codes = {name: code for name, code, _ in got["torch"]}
    assert (codes["conflict"], codes["exists"], codes["not found"],
            codes["bad json"], codes["delete again"]) == (409, 409, 404,
                                                         400, 404)
    assert [e["type"] for e in got["torch"][-1][2]] == ["MODIFIED",
                                                        "DELETED"]


def remote_scenario(remote, store, tu) -> list:
    """The sequence through a RemoteStore: results as masked dicts,
    errors as their class name (the store's exception taxonomy)."""
    out = []

    def step(name, fn, *args):
        try:
            result = fn(*args)
        except Exception as e:  # the error kind is the result
            out.append((name, type(e).__name__))
            return None
        if isinstance(result, list) and all(hasattr(o, "to_dict")
                                            for o in result):
            out.append((name, [mask(o.to_dict()) for o in result]))
        elif hasattr(result, "to_dict"):
            out.append((name, mask(result.to_dict())))
        else:
            out.append((name, result))
        return result

    for name, color in (("j1", "red"), ("j2", "blue"), ("j3", "red")):
        job = tu.new_tpujob(worker=2, name=name)
        job.metadata.labels["color"] = color
        step(f"create {name}", remote.create, store.TPUJOBS, job)
    j1 = step("get", remote.get, store.TPUJOBS, "default", "j1")
    step("selector", remote.list, store.TPUJOBS, "default",
         {"color": "red"})
    items, after, _ = remote.list_page(store.TPUJOBS, "default", None, 2)
    rest, end, _ = remote.list_page(store.TPUJOBS, "default", None, 2, after)
    out.append(("pages", [o.metadata.name for o in items], after,
                [o.metadata.name for o in rest], end))
    j1.spec.replica_specs["worker"].replicas = 3
    updated = step("update", remote.update, store.TPUJOBS, j1)
    since = updated.metadata.resource_version
    updated.status.conditions = []
    step("status", remote.update_status, store.TPUJOBS, updated)
    step("conflict", remote.update, store.TPUJOBS, j1)
    step("exists", remote.create, store.TPUJOBS, j1)
    step("not found", remote.get, store.TPUJOBS, "default", "missing")
    step("unknown kind", remote.get, "nonsense", "default", "x")
    step("delete", remote.delete, store.TPUJOBS, "default", "j2")
    step("try delete", remote.try_delete, store.TPUJOBS, "default", "j2")
    step("keys", lambda: sorted(n for _, n, _ in remote.keys(store.TPUJOBS)))
    events = []
    watcher = remote.watch(store.TPUJOBS, lambda et, obj: events.append(
        (et, mask(obj.to_dict()))), since_rv=since)
    assert wait_for(lambda: len(events) >= 2, 10)
    time.sleep(0.3)
    watcher.stop()
    out.append(("watch", events))
    return out


@pytest.mark.parametrize("client,server", [("jax", "jax"), ("torch", "torch"),
                                           ("jax", "torch"),
                                           ("torch", "jax")])
def test_remote_store_either_way(both_servers, client, server):
    """Each package's RemoteStore against each package's APIServer gives
    the JAX client's transcript against the JAX server."""
    transcripts = {}
    for c, s in {("jax", "jax"), (client, server)}:
        smod, _, rmod, tu = PACKAGES[c]
        store, srv = both_servers[s]
        for job in store.list(PACKAGES[s][0].TPUJOBS):
            store.delete(PACKAGES[s][0].TPUJOBS, job.metadata.namespace,
                         job.metadata.name)
        remote = rmod.RemoteStore(srv.url)
        try:
            transcripts[(c, s)] = remote_scenario(remote, smod, tu)
        finally:
            remote.stop_watchers()
    want = transcripts[("jax", "jax")]
    assert transcripts[(client, server)] == want
    assert dict((s[0], s[1]) for s in want if len(s) == 2)["conflict"] == \
        "ConflictError"


def test_job_file_reads_back_the_same_through_either_client(both_servers):
    """A job file (the wire dict of a 2-worker ``h100-8`` job with a ps)
    submitted through either package's client to either server reads
    back the same ``to_dict()``."""
    from tf_operator_tpu.sdk import TPUJobClient as JClient

    job = testutil.new_tpujob(worker=2, ps=1, name="filejob")
    job.spec.slice.accelerator = "h100-8"
    job.spec.run_policy.clean_pod_policy = "None"
    doc = json.loads(json.dumps(job.to_dict()))
    seen = []
    for server in ("jax", "torch"):
        url = both_servers[server][1].url
        for i, client_cls in enumerate((JClient, TPUJobClient)):
            client = client_cls.connect(url)
            name = f"filejob-{i}"
            client.create(dict(doc, metadata=dict(doc["metadata"],
                                                  name=name)))
            got = client.get(name).to_dict()
            got["metadata"]["name"] = "filejob"
            seen.append(mask(got))
            client.store.stop_watchers()
    assert all(s == seen[0] for s in seen[1:])
    assert seen[0]["spec"] == mask(doc["spec"])


# ---------------------------------------------------------------------------
# The same resolution as the JAX agent's
# ---------------------------------------------------------------------------

def _placed_store(package: str, job_name: str, pods):
    """An in-process store of ``package`` holding ``pods``:
    (name, host, ports) placements in namespace default."""
    smod = PACKAGES[package][0]
    types = sys.modules[PACKAGES[package][3].__name__.rsplit(
        ".", 1)[0] + ".api.types"]
    store = smod.Store()
    for name, host, ports in pods:
        store.create(smod.PODS, types.Pod(
            metadata=types.ObjectMeta(name=f"{job_name}-{name}"),
            status=types.PodStatus(host=host, ports=dict(ports))))
    return store


def _envs(job_name: str, worker: int, ps: int = 0):
    """Each package's env of worker 1 (worker 0 alone) of the job."""
    index = 1 if worker > 1 else 0
    return (j_render(jtestutil.new_tpujob(worker=worker, ps=ps,
                                          name=job_name), "worker", index),
            t_render(testutil.new_tpujob(worker=worker, ps=ps,
                                         name=job_name), "worker", index))


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_master_addr_port_is_the_jax_coordinator(package):
    """Over the same placements (rank 0 on 10.0.0.7:41000), the port's
    resolved MASTER_ADDR:MASTER_PORT is the JAX resolver's
    JAX_COORDINATOR_ADDRESS, with either package's store."""
    store = _placed_store(package, "rz", [
        ("worker-0", "10.0.0.7", {"coordinator": 41000}),
        ("worker-1", "10.0.0.8", {"coordinator": 41001})])
    jenv, tenv = _envs("rz", worker=2)
    assert tenv["MASTER_ADDR"] == \
        jenv["JAX_COORDINATOR_ADDRESS"].split(":")[0]
    pod = Pod(metadata=ObjectMeta(name="rz-worker-1"))
    jout = jagent.ControlPlaneEnvResolver(store, timeout=2).resolve(pod, jenv)
    tout = tagent.ControlPlaneEnvResolver(store, timeout=2).resolve(pod, tenv)
    assert f"{tout['MASTER_ADDR']}:{tout['MASTER_PORT']}" == \
        jout["JAX_COORDINATOR_ADDRESS"] == "10.0.0.7:41000"
    assert (tout["RANK"], tout["WORLD_SIZE"]) == ("1", "2")
    assert tout["TPUJOB_CLUSTER_SPEC"] == jout["TPUJOB_CLUSTER_SPEC"]
    # The JAX resolver leaves the torch keys alone, the port's the JAX ones.
    assert jagent.ControlPlaneEnvResolver(store, timeout=2).resolve(
        pod, tenv)["MASTER_ADDR"] == "rz-worker-0.default.svc"
    assert tagent.ControlPlaneEnvResolver(store, timeout=2).resolve(
        pod, jenv)["JAX_COORDINATOR_ADDRESS"] == jenv[
            "JAX_COORDINATOR_ADDRESS"]


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_ps_cluster_spec_resolves_byte_equal(package):
    """A worker of a ps job: each resolver on each package's env gives
    the same bytes."""
    store = _placed_store(package, "pz", [
        ("ps-0", "10.1.0.1", {"coordinator": 42000}),
        ("worker-0", "10.1.0.2", {"coordinator": 42001}),
        ("worker-1", "10.1.0.3", {"coordinator": 42002})])
    jenv, tenv = _envs("pz", worker=2, ps=1)
    assert jenv["TPUJOB_CLUSTER_SPEC"] == tenv["TPUJOB_CLUSTER_SPEC"]
    pod = Pod(metadata=ObjectMeta(name="pz-worker-1"))
    specs = {(r, e): mod.ControlPlaneEnvResolver(store, timeout=2).resolve(
        pod, env)["TPUJOB_CLUSTER_SPEC"]
        for r, mod in (("jax", jagent), ("torch", tagent))
        for e, env in (("jax", jenv), ("torch", tenv))}
    assert len(set(specs.values())) == 1
    assert json.loads(specs["torch", "torch"])["cluster"]["ps"] == [
        "10.1.0.1:42000"]


@pytest.mark.parametrize("case", ["timeout", "no port", "ps no port"])
def test_resolver_errors_as_jax(case):
    """Rank 0 (or the ps) never placed: TimeoutError; placed with no
    coordinator port: RuntimeError; the same type and message in both."""
    placements = {"timeout": [],
                  "no port": [("worker-0", "10.0.0.7", {})],
                  "ps no port": [("ps-0", "10.0.0.9", {}),
                                 ("worker-0", "10.0.0.7",
                                  {"coordinator": 1})]}[case]
    store = _placed_store("torch", "ez", placements)
    jenv, tenv = _envs("ez", worker=2, ps=1 if case == "ps no port" else 0)
    if case == "ps no port":
        jenv = {"TPUJOB_CLUSTER_SPEC": jenv["TPUJOB_CLUSTER_SPEC"]}
        tenv = {"TPUJOB_CLUSTER_SPEC": tenv["TPUJOB_CLUSTER_SPEC"]}
    pod = Pod(metadata=ObjectMeta(name="ez-worker-1"))
    errors = []
    for mod, env in ((jagent, jenv), (tagent, tenv)):
        with pytest.raises((TimeoutError, RuntimeError)) as err:
            mod.ControlPlaneEnvResolver(store, timeout=0.2).resolve(pod, env)
        errors.append((type(err.value), str(err.value)))
    assert errors[0] == errors[1]
    assert errors[1][0] is (TimeoutError if case == "timeout"
                            else RuntimeError)
