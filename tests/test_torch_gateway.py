"""The port's serving gateway (``tf_operator_tpu_torch/serve/gateway.py``):
the cases of ``tests/test_gateway.py`` against the port's gateway and the
port's worker (fake runner), plus the parity of its token map and its
metrics exposition with the JAX package's.

Auth token -> tenant lane, 401/400/404, health, 429 + Retry-After at the
backlog limit, 504 with the request retracted, and streaming NDJSON
responses served by a real worker loop over the spool. The 429 case fills
the backlog before the request, with no worker running, and the gateway
counts an answer before it writes it, so no step races another.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import pytest

from tf_operator_tpu.runtime import metrics as jmetrics
from tf_operator_tpu.serve.gateway import parse_token_map as j_parse
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.serve import worker as worker_mod
from tf_operator_tpu_torch.serve.gateway import (
    GatewayServer,
    SpoolClient,
    main,
    parse_token_map,
)

pytestmark = pytest.mark.control_plane


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


def _error(url, payload=None, token=None, data=None):
    """The HTTPError a request gets."""
    if data is None:
        data = json.dumps(payload).encode()
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    return e.value


@pytest.fixture
def gateway(tmp_path):
    gw = GatewayServer(str(tmp_path / "spool"), port=0,
                       tokens={"tok-a": "alpha", "tok-b": "beta"},
                       max_queue_depth=4, retry_after_seconds=3.0,
                       timeout_seconds=20.0)
    gw.start()
    yield gw
    gw.stop()


def _url(gw, path="/v1/generate"):
    return f"http://127.0.0.1:{gw.port}{path}"


@pytest.fixture
def worker(gateway, monkeypatch):
    """The port's serving worker (its main loop, FakeRunner) claiming from
    the gateway's spool on a thread."""
    spool_root = gateway.spool.root
    for name in list(os.environ):
        if name.startswith("TPUJOB_"):
            monkeypatch.delenv(name)
    monkeypatch.setenv("TPUJOB_SERVE_SPOOL", spool_root)
    monkeypatch.setenv("TPUJOB_POD_NAME", "gw-worker-0")
    monkeypatch.setenv("TPUJOB_SERVE_TENANT_WEIGHTS", "alpha=3,beta=1")
    result = []
    t = threading.Thread(
        target=lambda: result.append(worker_mod.main(
            ["--runner", "fake", "--poll-interval", "0.005"])),
        daemon=True)
    t.start()
    yield t
    with open(os.path.join(spool_root, worker_mod.CLOSE_SENTINEL),
              "w") as f:
        f.write("")
    t.join(timeout=30)
    assert not t.is_alive() and result == [0]


def _fake_tokens(prompt, n):
    """FakeRunner's deterministic output (serve/batcher.py)."""
    seed = sum(prompt) + len(prompt)
    return [(seed + i) % 251 for i in range(n)]


@pytest.mark.parametrize("raw", ["a=t1, b=t2", "", "malformed,x=t",
                                 "k=,=v, y = t3 ,z=t=4"])
def test_parse_token_map_matches_jax(raw):
    assert parse_token_map(raw) == j_parse(raw)
    assert parse_token_map("a=t1, b=t2") == {"a": "t1", "b": "t2"}


class TestAdmission:
    def test_unknown_token_is_401(self, gateway):
        assert _error(_url(gateway), {"prompt": [1]}, "nope").code == 401

    def test_missing_token_is_401_when_tokens_configured(self, gateway):
        assert _error(_url(gateway), {"prompt": [1]}).code == 401

    def test_malformed_body_is_400(self, gateway):
        assert _error(_url(gateway), token="tok-a",
                      data=b"{not json").code == 400

    def test_empty_prompt_is_400(self, gateway):
        assert _error(_url(gateway), {"prompt": []}, "tok-a").code == 400
        assert _error(_url(gateway), {"prompt": [1], "maxNewTokens": 0},
                      "tok-a").code == 400

    def test_unknown_paths_are_404(self, gateway):
        assert _error(_url(gateway, "/v2/x"), {"prompt": [1]},
                      "tok-a").code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(_url(gateway, "/nope"), timeout=30)
        assert e.value.code == 404

    def test_healthz(self, gateway):
        with urllib.request.urlopen(_url(gateway, "/healthz")) as resp:
            assert resp.status == 200

    def test_backpressure_429_carries_retry_after(self, gateway):
        """A backlog at maxQueueDepth -> 429 before anything is spooled,
        Retry-After in the header and the body, and the answer counted
        once the client has it."""
        client = SpoolClient(gateway.spool.root)
        for i in range(4):  # fill to max_queue_depth with no worker
            client.submit(f"fill{i}", "alpha", [1], 1)
        before = metrics.gateway_requests.value(code="429")
        err = _error(_url(gateway), {"prompt": [1, 2]}, "tok-a")
        assert err.code == 429
        assert err.headers["Retry-After"] == "3"
        assert json.loads(err.read())["retryAfterSeconds"] == 3.0
        assert client.depth() == 4  # nothing was written
        assert metrics.gateway_requests.value(code="429") == before + 1

    def test_no_replica_is_504_and_retracts(self, tmp_path):
        gw = GatewayServer(str(tmp_path / "spool"), port=0,
                           timeout_seconds=0.05, poll_interval=0.005)
        gw.start()
        try:
            err = _error(_url(gw), {"prompt": [3]})
            body = json.loads(err.read())
        finally:
            gw.stop()
        assert err.code == 504
        assert body["retracted"] is True
        assert gw.spool.depth() == 0

    def test_main_needs_a_spool(self, monkeypatch):
        monkeypatch.delenv("TPUJOB_SERVE_SPOOL", raising=False)
        assert main([]) == 2


class TestStreaming:
    def test_stream_tokens_and_trailer(self, gateway, worker):
        """HTTP -> spool -> the port's worker (FakeRunner) -> done/ ->
        chunked NDJSON: the runner's tokens, then the trailer with the
        tenant, the replica and the TTFT; the answer is counted and
        timed."""
        before = metrics.gateway_requests.value(code="200")
        timed = metrics.gateway_streaming_seconds.count_value()
        prompt = [1, 2, 3]
        lines = _post_lines(_url(gateway),
                            {"prompt": prompt, "maxNewTokens": 4},
                            token="tok-a")
        tokens = [ln["token"] for ln in lines if "token" in ln]
        assert tokens == _fake_tokens(prompt, 4)
        trailer = lines[-1]
        assert trailer["done"] is True
        assert trailer["tenant"] == "alpha"
        assert trailer["servedBy"] == "gw-worker-0"
        assert trailer["ttftSeconds"] >= 0.0
        assert metrics.gateway_requests.value(code="200") == before + 1
        assert metrics.gateway_streaming_seconds.count_value() == timed + 1
        with urllib.request.urlopen(_url(gateway, "/metrics")) as resp:
            text = resp.read().decode()
        assert 'tpu_operator_gateway_requests_total{code="200"}' in text
        assert "tpu_operator_gateway_streaming_seconds_count" in text

    def test_auth_token_maps_to_tenant_lane(self, gateway, worker):
        a = _post_lines(_url(gateway), {"prompt": [5], "maxNewTokens": 2},
                        token="tok-a")[-1]
        b = _post_lines(_url(gateway), {"prompt": [5], "maxNewTokens": 2},
                        token="tok-b")[-1]
        assert a["tenant"] == "alpha"
        assert b["tenant"] == "beta"

    def test_open_gateway_uses_default_tenant(self, gateway, worker):
        open_gw = GatewayServer(gateway.spool.root, port=0, tokens={},
                                default_tenant="anon",
                                timeout_seconds=20.0)
        open_gw.start()
        try:
            trailer = _post_lines(_url(open_gw), {"prompt": [9],
                                                  "maxNewTokens": 2})[-1]
            assert trailer["tenant"] == "anon"
        finally:
            open_gw.stop()


def _exposition(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        text = resp.read().decode()
    return text, {line.split()[2] for line in text.splitlines()
                  if line.startswith("# TYPE ")}


def test_operator_metrics_show_the_embedded_gateway(tmp_path, monkeypatch):
    """With ``--enable-serving-gateway`` the gateway counts into the
    operator's one registry: its answers show on the operator's
    ``/metrics``, and its own ``/metrics`` renders the whole catalogue."""
    from tf_operator_tpu_torch.cli import Server, build_parser

    monkeypatch.delenv("TPUJOB_GATEWAY_TOKENS", raising=False)
    server = Server(build_parser().parse_args([
        "--monitoring-port", "-1", "--no-leader-elect",
        "--enable-serving-gateway", "--gateway-port", "0",
        "--gateway-spool", str(tmp_path / "spool")]))
    server.start()
    try:
        before = metrics.gateway_requests.value(code="400")
        assert _error(_url(server.gateway), {"prompt": []}).code == 400
        operator_text, operator_names = _exposition(
            f"http://127.0.0.1:{server.monitoring.port}/metrics")
        _, gateway_names = _exposition(_url(server.gateway, "/metrics"))
    finally:
        server.shutdown()
    line = 'tpu_operator_gateway_requests_total{code="400"} '
    counted = [ln for ln in operator_text.splitlines() if ln.startswith(line)]
    assert counted == [f"{line}{int(before) + 1}"]
    assert gateway_names == operator_names
    assert {"tpu_operator_jobs_created_total",
            "tpu_operator_serving_ttft_seconds"} <= gateway_names


def test_exposition_matches_jax():
    """The port's counter and histogram render the same text exposition
    as the JAX registry's for the same observations."""
    port_c = metrics.Counter("t_requests_total", "help", ("code",))
    jax_c = jmetrics.Counter("t_requests_total", "help", ("code",))
    buckets = (0.01, 0.5, 2.0)
    port_h = metrics.Histogram("t_seconds", "help", (), buckets=buckets)
    jax_h = jmetrics.Histogram("t_seconds", "help", (), buckets=buckets)
    for code in ("200", "429", "200"):
        port_c.inc(code=code)
        jax_c.inc(code=code)
    for value in (0.003, 0.75, 9.0):
        port_h.observe(value)
        jax_h.observe(value)
    assert port_c.render() == jax_c.render()
    assert port_h.render() == jax_h.render()
    registry = metrics.Registry()
    registry._register(port_h)
    registry._register(port_c)
    # By name, as the JAX registry renders.
    assert registry.render_text() == "\n".join(
        jax_c.render() + jax_h.render()) + "\n"
