"""The port's command line against the JAX package's.

- ``build_parser()``: every flag of the JAX parser, with its default,
  choices, type and arity, and no other flag;
- ``parse_int_map`` on the cases of ``tests/test_cli.py``, results and
  errors as JAX's;
- ``main()``: each ``parser.error`` of the JAX ``main()`` is a usage
  error (exit 2) of the port's too, with the same message; ``--version``
  wins;
- ``--backend kube`` builds the port's ``KubeOperator`` against the
  port's fake API server, with the Kubernetes lease store, as JAX's does;
- ``Server``: the same planes as the JAX ``Server`` for each flag set,
  and the served API (tokens, TLS) and monitoring it starts;
- the JSON log line of ``runtime/logconfig.py`` as JAX's.
"""

import argparse
import io
import json
import logging
import urllib.error
import urllib.request

import pytest

from tf_operator_tpu import cli as jcli
from tf_operator_tpu.runtime import logconfig as jlogconfig
from tf_operator_tpu_torch import cli as tcli
from tf_operator_tpu_torch import testutil
from tf_operator_tpu_torch.runtime import logconfig as tlogconfig
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.apiserver import wait_for_server
from tf_operator_tpu_torch.runtime.remote import RemoteStore

pytestmark = pytest.mark.control_plane

BASE = ["--monitoring-port", "0", "--no-leader-elect"]


def _flags(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


JAX_FLAGS = sorted(_flags(jcli.build_parser()))


def test_parsers_have_the_same_flags():
    assert sorted(_flags(tcli.build_parser())) == JAX_FLAGS


@pytest.mark.parametrize("dest", JAX_FLAGS)
def test_flag_matches_jax(dest, monkeypatch):
    """Option strings, default, choices, arity and type of one flag."""
    monkeypatch.delenv("TPU_OPERATOR_NAMESPACE", raising=False)
    want = _flags(jcli.build_parser())[dest]
    got = _flags(tcli.build_parser())[dest]
    for attr in ("option_strings", "default", "choices", "nargs", "const",
                 "required"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert type(got) is type(want)
    assert getattr(got.type, "__name__", got.type) == \
        getattr(want.type, "__name__", want.type)


@pytest.mark.parametrize("raw", ["", "   ", "prod=100",
                                 "prod=100, batch=10 ,best-effort=0",
                                 "low=-5,", "prod", "=5", "prod=ten",
                                 {"prod": 1}])
def test_parse_int_map_as_jax(raw):
    try:
        want = jcli.parse_int_map(raw)
    except argparse.ArgumentTypeError as err:
        with pytest.raises(argparse.ArgumentTypeError) as got:
            tcli.parse_int_map(raw)
        assert str(got.value) == str(err)
        return
    got = tcli.parse_int_map(raw)
    assert got == want
    if isinstance(raw, dict):
        assert got is not raw


REJECTED = {
    "none without api": ["--backend", "none"],
    "tenant without gang": ["--enable-tenant-queues"],
    "queue config without tenant": ["--queue-config", "q.yaml"],
    "elastic without gang": ["--enable-elastic"],
    "autoscaler without serving": ["--enable-serving-autoscaler"],
    "gateway without spool": ["--enable-serving-gateway"],
    "elastic on kube": ["--enable-gang-scheduling", "--enable-elastic",
                        "--backend", "kube"],
    "autoscaler on kube": ["--enable-gang-scheduling", "--enable-elastic",
                           "--enable-serving", "--enable-serving-autoscaler",
                           "--backend", "kube"],
    "no shards": ["--shards", "0"],
    "shard index out of range": ["--shards", "2", "--shard-index", "2"],
    "shards on kube": ["--shards", "2", "--backend", "kube"],
    "shards without election": ["--shards", "2"],
    "api on kube": ["--backend", "kube", "--api-port", "8080"],
    "malformed map": ["--gang-priority-classes", "prod=high"],
    "unknown backend": ["--backend", "k8s"],
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_main_rejects_as_jax(case, capsys):
    argv = BASE + REJECTED[case]
    errors = []
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.splitlines()[-1])
    assert errors[1] == errors[0].replace("tpu-operator:",
                                          "tpu-operator-torch:")


KUBECONFIG = """\
apiVersion: v1
kind: Config
current-context: t
contexts:
  - name: t
    context: {{cluster: t, user: t}}
clusters:
  - name: t
    cluster: {{server: "{server}"}}
users:
  - name: t
    user: {{}}
"""


def test_kube_backend_builds_a_kube_operator(tmp_path):
    """``--backend kube`` against the port's fake: the Server holds the
    port's ``KubeOperator`` (its Store the informer cache, a
    ``GPUJobController`` inside) and leads through a Kubernetes Lease;
    flags reach the operator as in JAX."""
    from tf_operator_tpu_torch.controller.gpu_controller import (
        GPUJobController,
    )
    from tf_operator_tpu_torch.runtime.kube import (
        KubeLeaseStore,
        KubeOperator,
    )
    from tf_operator_tpu_torch.runtime.kube_fake import FakeKubeApiServer

    with FakeKubeApiServer() as fake:
        kubeconfig = tmp_path / "kubeconfig"
        kubeconfig.write_text(KUBECONFIG.format(server=fake.url))
        args = tcli.build_parser().parse_args(BASE + [
            "--backend", "kube", "--kubeconfig", str(kubeconfig),
            "--enable-gang-scheduling", "--enable-ckpt-coordination",
            "--agent-relay-dir", str(tmp_path / "relay")])
        server = tcli.Server(args)
        try:
            assert isinstance(server.operator, KubeOperator)
            assert isinstance(server.operator.controller, GPUJobController)
            assert server.store is server.operator.store
            assert isinstance(server._lease_store, KubeLeaseStore)
            assert server.operator.ckpt is not None
            assert server.operator.binder is not None
        finally:
            server.shutdown()


def test_version_wins_over_validation(capsys):
    assert tcli.main(["--backend", "none", "--version"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("tpu-operator-torch v") and "jax" not in out


PLANE_FLAGS = {
    "none": [],
    "gang": ["--enable-gang-scheduling", "--total-chips", "16",
             "--gang-fairness", "strict", "--gang-priority-classes",
             "prod=100,batch=10", "--gang-queue-quotas", "prod=8",
             "--gang-preemption"],
    "elastic": ["--enable-gang-scheduling", "--enable-elastic"],
    "every plane": ["--enable-gang-scheduling", "--enable-tenant-queues",
                    "--enable-elastic", "--enable-ckpt-coordination",
                    "--enable-serving", "--enable-serving-autoscaler"],
    "no slice health": ["--enable-gang-scheduling",
                        "--no-enable-slice-health"],
    "shards": ["--shards", "2", "--leader-elect", "--shard-index", "1"],
    "backend none": ["--backend", "none", "--api-port", "-1"],
}


def planes(server) -> dict:
    op = server.operator
    out = {"operator": type(op).__name__,
           "elector": server.elector is not None,
           "api": server.api_server is not None,
           "gateway": server.gateway is not None,
           "monitoring": server.monitoring is not None}
    if type(op).__name__ == "ShardedOperator":
        return dict(out, shards=op.shards)
    gang = op.controller.engine.gang
    out.update({name: getattr(op, name) is not None
                for name in ("quota", "ckpt", "health", "autoscaler",
                             "serving", "backend")})
    if gang is not None:
        out["gang"] = (gang.priority_classes, gang.queue_quotas,
                       gang.preemption, gang.elastic)
    return out


@pytest.mark.parametrize("case", sorted(PLANE_FLAGS))
def test_server_builds_the_planes_jax_builds(case, tmp_path):
    argv = BASE + PLANE_FLAGS[case]
    built = []
    for cli in (jcli, tcli):
        server = cli.Server(cli.build_parser().parse_args(argv))
        if server.api_server is not None:
            server.start()  # shutdown() waits for the serving loop
        try:
            built.append(planes(server))
        finally:
            server.shutdown()
    assert built[1] == built[0]


def test_serving_front_door_wires_up(tmp_path):
    args = tcli.build_parser().parse_args(BASE + [
        "--enable-gang-scheduling", "--enable-elastic", "--enable-serving",
        "--enable-serving-autoscaler", "--enable-serving-gateway",
        "--gateway-port", "0", "--gateway-spool", str(tmp_path / "spool")])
    server = tcli.Server(args)
    try:
        autoscaler = server.operator.autoscaler
        gang = server.operator.controller.engine.gang
        assert autoscaler.gang is gang
        assert gang.resize_signals == autoscaler.signals
        assert server.gateway.spool.root == str(tmp_path / "spool")
    finally:
        server.shutdown()


def test_served_api_with_tokens_tls_and_monitoring(tmp_path):
    """``--backend none --api-port -1`` with a token file and a
    self-signed certificate: the store is served over HTTPS, roles hold,
    and the monitoring endpoint answers with the port's version."""
    tokens = tmp_path / "tokens"
    tokens.write_text("adm admin\nview read-only\n")
    args = tcli.build_parser().parse_args([
        "--no-leader-elect", "--backend", "none", "--api-port", "-1",
        "--api-tokens-file", str(tokens), "--api-self-signed-tls-dir",
        str(tmp_path / "tls"), "--api-tls-san", "10.0.0.5,op.example",
        "--monitoring-port", "-1", "--resync-period", "0"])
    server = tcli.Server(args)
    server.start()
    try:
        url, ca = server.api_server.url, str(tmp_path / "tls" / "cert.pem")
        assert url.startswith("https://127.0.0.1:")
        wait_for_server(url, ca_file=ca)
        admin = RemoteStore(url, token="adm", ca_file=ca)
        admin.create(store_mod.TPUJOBS,
                     testutil.new_tpujob(worker=1, name="served"))
        assert server.store.get(store_mod.TPUJOBS, "default", "served")
        with pytest.raises(RuntimeError, match="403"):
            RemoteStore(url, token="view", ca_file=ca).delete(
                store_mod.TPUJOBS, "default", "served")
        base = f"http://127.0.0.1:{server.monitoring.port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
            assert r.read() == b"ok\n"
        with urllib.request.urlopen(f"{base}/version", timeout=5) as r:
            assert json.loads(r.read())["version"].startswith(
                "tpu-operator-torch")
        with urllib.request.urlopen(f"{base}/metrics", timeout=5) as r:
            assert b"tpu_operator_" in r.read()
        with urllib.request.urlopen(f"{base}/debug/stacks", timeout=5) as r:
            assert b"--- thread" in r.read()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/debug/jobs/default/nope",
                                   timeout=5)
        assert err.value.code == 404
    finally:
        server.shutdown()


def test_json_log_line_as_jax():
    """The JSON formatter writes the JAX one's keys and values, and a
    job logger carries the same fields."""
    class Job:
        class metadata:
            namespace, name, uid = "ns", "j", "u-1"

    lines = []
    for mod in (jlogconfig, tlogconfig):
        buf = io.StringIO()
        handler = logging.StreamHandler(buf)
        handler.setFormatter(mod.JSONFormatter())
        base = logging.getLogger(f"torch-cli-test-{mod.__name__}")
        base.handlers[:] = [handler]
        base.propagate = False
        mod.logger_for_job(base, Job, "worker", 1).warning("hello %d", 3)
        line = json.loads(buf.getvalue())
        line.pop("time")
        line.pop("logger")
        lines.append(line)
    assert lines[1] == lines[0]
    assert lines[1]["job"] == "ns.j" and lines[1]["replica_index"] == 1
