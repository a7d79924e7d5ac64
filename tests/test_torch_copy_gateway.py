"""Copy of ``tests/test_gateway.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Serving HTTP gateway e2e: auth-token -> tenant QoS lane mapping,
streaming NDJSON responses served by a REAL serving worker over the
spool, backpressure as 429 + Retry-After, and the ClusterQueue-nominal
weight rendering the gateway's tenants flow into.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import pytest

from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.serve import worker as worker_mod
from tf_operator_tpu_torch.serve.gateway import (
    GatewayServer,
    SpoolClient,
    parse_token_map,
)

NS = "default"


def _post(url, payload, token=None, timeout=30):
    headers = {}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers=headers, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def _post_lines(url, payload, token=None):
    """POST and parse the chunked NDJSON stream into dicts."""
    with _post(url, payload, token=token) as resp:
        return [json.loads(line) for line in
                resp.read().decode().strip().splitlines()]


@pytest.fixture
def gateway(tmp_path):
    gw = GatewayServer(str(tmp_path / "spool"), port=0,
                       tokens={"tok-a": "alpha", "tok-b": "beta"},
                       max_queue_depth=4, retry_after_seconds=3.0,
                       timeout_seconds=20.0)
    gw.start()
    yield gw
    gw.stop()


@pytest.fixture
def worker(gateway, monkeypatch):
    """A REAL serving worker (serve/worker.py main loop, FakeRunner)
    claiming from the gateway's spool on a daemon thread."""
    spool_root = gateway.spool.root
    monkeypatch.setenv("TPUJOB_SERVE_SPOOL", spool_root)
    monkeypatch.setenv("TPUJOB_POD_NAME", "gw-worker-0")
    monkeypatch.setenv("TPUJOB_SERVE_TENANT_WEIGHTS", "alpha=3,beta=1")
    monkeypatch.delenv("TPUJOB_PREEMPT_FILE", raising=False)
    monkeypatch.delenv("TPUJOB_CKPT_FILE", raising=False)
    monkeypatch.delenv("TPUJOB_RESTORE_STEP", raising=False)
    t = threading.Thread(
        target=worker_mod.main,
        args=(["--runner", "fake", "--poll-interval", "0.005"],),
        daemon=True)
    t.start()
    yield t
    with open(os.path.join(spool_root, worker_mod.CLOSE_SENTINEL),
              "w") as f:
        f.write("")
    t.join(timeout=30)


def _fake_tokens(prompt, n):
    """FakeRunner's deterministic output (serve/batcher.py)."""
    seed = sum(prompt) + len(prompt)
    return [(seed + i) % 251 for i in range(n)]


class TestTokenMap:
    def test_parse(self):
        assert parse_token_map("a=t1, b=t2") == {"a": "t1", "b": "t2"}
        assert parse_token_map("") == {}
        assert parse_token_map("malformed,x=t") == {"x": "t"}


class TestAdmission:
    def test_unknown_token_is_401(self, gateway):
        url = f"http://127.0.0.1:{gateway.port}/v1/generate"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, {"prompt": [1]}, token="nope")
        assert e.value.code == 401

    def test_missing_token_is_401_when_tokens_configured(self, gateway):
        url = f"http://127.0.0.1:{gateway.port}/v1/generate"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, {"prompt": [1]})
        assert e.value.code == 401

    def test_malformed_body_is_400(self, gateway):
        url = f"http://127.0.0.1:{gateway.port}/v1/generate"
        req = urllib.request.Request(
            url, data=b"{not json",
            headers={"Authorization": "Bearer tok-a"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 400

    def test_empty_prompt_is_400(self, gateway):
        url = f"http://127.0.0.1:{gateway.port}/v1/generate"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, {"prompt": []}, token="tok-a")
        assert e.value.code == 400

    def test_healthz(self, gateway):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{gateway.port}/healthz") as resp:
            assert resp.status == 200

    def test_backpressure_429_carries_retry_after(self, gateway):
        """maxQueueDepth backlog -> 429 BEFORE anything is spooled,
        with Retry-After in the header and body — the HTTP spelling of
        the queue's reject-don't-buffer contract."""
        client = SpoolClient(gateway.spool.root)
        for i in range(4):  # fill to max_queue_depth with no worker
            client.submit(f"fill{i}", "alpha", [1], 1)
        url = f"http://127.0.0.1:{gateway.port}/v1/generate"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, {"prompt": [1, 2]}, token="tok-a")
        err = e.value
        assert err.code == 429
        assert err.headers["Retry-After"] == "3"
        assert json.loads(err.read())["retryAfterSeconds"] == 3.0
        assert client.depth() == 4  # nothing was written
        assert metrics.gateway_requests.value(code="429") >= 1


class TestStreaming:
    def test_stream_tokens_and_trailer(self, gateway, worker):
        """Full path: HTTP -> spool -> real worker (FakeRunner) ->
        done/ -> chunked NDJSON stream. Token values must be the
        runner's deterministic sequence; the trailer carries identity
        + TTFT."""
        url = f"http://127.0.0.1:{gateway.port}/v1/generate"
        prompt = [1, 2, 3]
        lines = _post_lines(url, {"prompt": prompt, "maxNewTokens": 4},
                            token="tok-a")
        tokens = [ln["token"] for ln in lines if "token" in ln]
        assert tokens == _fake_tokens(prompt, 4)
        trailer = lines[-1]
        assert trailer["done"] is True
        assert trailer["tenant"] == "alpha"
        assert trailer["servedBy"] == "gw-worker-0"
        assert trailer["ttftSeconds"] >= 0.0

    def test_auth_token_maps_to_tenant_lane(self, gateway, worker):
        """tok-a and tok-b land in DIFFERENT tenant lanes: the tenant
        the gateway resolves from the bearer token is the lane the
        worker's RequestQueue files the request under (weights come
        from ClusterQueue nominals in production; the env rendering is
        pinned below)."""
        url = f"http://127.0.0.1:{gateway.port}/v1/generate"
        a = _post_lines(url, {"prompt": [5], "maxNewTokens": 2},
                        token="tok-a")[-1]
        b = _post_lines(url, {"prompt": [5], "maxNewTokens": 2},
                        token="tok-b")[-1]
        assert a["tenant"] == "alpha"
        assert b["tenant"] == "beta"

    def test_open_gateway_uses_default_tenant(self, tmp_path, worker,
                                              gateway):
        """Empty token map = open gateway: everything files under the
        default tenant (dev mode; production sets --gateway-tokens)."""
        open_gw = GatewayServer(gateway.spool.root, port=0, tokens={},
                                default_tenant="anon",
                                timeout_seconds=20.0)
        open_gw.start()
        try:
            url = f"http://127.0.0.1:{open_gw.port}/v1/generate"
            trailer = _post_lines(url, {"prompt": [9],
                                        "maxNewTokens": 2})[-1]
            assert trailer["tenant"] == "anon"
        finally:
            open_gw.stop()


class TestClusterQueueWeights:
    def test_nominal_chips_render_as_lane_weights(self):
        """The weight string the worker fixture hardcodes is what the
        ServingManager renders from ClusterQueue nominals — gateway
        tenants inherit chip fair share as request fair share."""
        from tf_operator_tpu_torch.api.types import (
            ClusterQueue,
            ClusterQueueSpec,
            TenantQueue,
            TenantQueueSpec,
        )
        from tf_operator_tpu_torch.controller.serving import ServingManager
        from tf_operator_tpu_torch.runtime import store as store_mod
        from tf_operator_tpu_torch.runtime.store import Store

        store = Store()
        for name, chips in (("alpha", 3), ("beta", 1)):
            cq = ClusterQueue(spec=ClusterQueueSpec(nominal_chips=chips))
            cq.metadata.name = f"cq-{name}"
            cq.metadata.namespace = ""
            store.create(store_mod.CLUSTERQUEUES, cq)
            tq = TenantQueue(spec=TenantQueueSpec(
                cluster_queue=f"cq-{name}"))
            tq.metadata.name = name
            tq.metadata.namespace = NS
            store.create(store_mod.TENANTQUEUES, tq)
        weights = ServingManager(store).tenant_weights(NS)
        assert weights == {"alpha": 3, "beta": 1}


pytestmark = pytest.mark.control_plane
