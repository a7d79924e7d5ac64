"""The port's kube node agent (``runtime/nodeagent.py``) against the JAX
package's, each against its own fake API server.

On one relay-wired pod bound to the agent's node, in both packages:
- a preemption notice stamped on the pod lands in the pod's notice file
  (``TPUJOB_PREEMPT_FILE``), the same bytes;
- a checkpoint state file the worker writes (``TPUJOB_CKPT_FILE``) is
  mirrored onto the pod as the same ``ckpt-state`` annotation;
- the heartbeat annotation lands on the Node and parses as fresh, and
  the Node converts to the same framework Node;
- deleting the pod removes its relay files; a pod on another node is
  never relayed.
The agent also starts as ``python -m tf_operator_tpu_torch.runtime.nodeagent``
with torch blocked (``tests/test_torch_import.py``).
"""

import datetime as dt
import json
import os
import time
import types

import pytest

from tf_operator_tpu.api import constants as jconst
from tf_operator_tpu.runtime import kube as jkube
from tf_operator_tpu.runtime import kube_fake as jfake
from tf_operator_tpu.runtime import nodeagent as jagent
from tf_operator_tpu.runtime import relay as jrelay
from tf_operator_tpu_torch.api import constants as tconst
from tf_operator_tpu_torch.runtime import kube as tkube
from tf_operator_tpu_torch.runtime import kube_fake as tfake
from tf_operator_tpu_torch.runtime import nodeagent as tagent
from tf_operator_tpu_torch.runtime import relay as trelay

pytestmark = pytest.mark.control_plane

PK = {
    "jax": types.SimpleNamespace(const=jconst, kube=jkube, fake=jfake,
                                 agent=jagent, relay=jrelay,
                                 domain_kw="ici_domain"),
    "torch": types.SimpleNamespace(const=tconst, kube=tkube, fake=tfake,
                                   agent=tagent, relay=trelay,
                                   domain_kw="nvlink_domain"),
}
NOTICE = json.dumps({"barrier": "b-1", "reason": "ScheduledMaintenance",
                     "deadline": "2026-01-01T00:00:30+00:00"},
                    sort_keys=True)
CKPT = {"step": 40, "saved": [10, 20, 40], "ackedBarrier": "b-1",
        "restoredFromStep": 0}


def wait_for(cond, what: str, timeout: float = 15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def relay_pod(pk, name: str, node: str, relay_dir: str) -> dict:
    """A plain pod bound to ``node`` with the relay volume mounted."""
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": "default", "annotations": {
            pk.const.ANNOTATION_RELAY_TOKEN: f"tok-{name}"}},
        "spec": {
            "nodeName": node, "restartPolicy": "Never",
            "containers": [{"name": pk.const.DEFAULT_CONTAINER_NAME,
                            "image": "w:latest", "command": ["sleep", "1"],
                            "volumeMounts": [{"name": "tpu-operator-relay",
                                              "mountPath": relay_dir}]}],
            "volumes": [{"name": "tpu-operator-relay",
                         "hostPath": {"path": relay_dir,
                                      "type": "DirectoryOrCreate"}}]}}


def relay_arc(pk, tmp_path):
    """Run one agent through notice, mirror, heartbeat and delete; return
    what each step left behind."""
    relay_dir = str(tmp_path / "relay")
    with pk.fake.FakeKubeApiServer() as fake:
        fake.state.add_node("na-node", chips=8, **{pk.domain_kw: "d1"})
        fake.state.add_node("other-node", chips=8)
        client = pk.kube.KubeClient(pk.kube.KubeConfig(server=fake.url))
        agent = pk.agent.KubeNodeAgent(client, "na-node", relay_dir,
                                       heartbeat_seconds=0.2,
                                       ckpt_poll_seconds=0.05).start()
        try:
            for name, node in (("w0", "na-node"), ("elsewhere", "other-node")):
                fake.state.create("pods", "default",
                                  relay_pod(pk, name, node, relay_dir))
            pods = {n: pk.kube.pod_from_k8s(fake.state.get("pods", "default",
                                                           n))
                    for n in ("w0", "elsewhere")}
            fake.state.patch("pods", "default", "w0", {"metadata": {
                "annotations": {pk.const.ANNOTATION_PREEMPT_NOTICE: NOTICE}}})
            fake.state.patch("pods", "default", "elsewhere", {"metadata": {
                "annotations": {pk.const.ANNOTATION_PREEMPT_NOTICE: NOTICE}}})
            notice_path = pk.relay.preempt_path(relay_dir, pods["w0"])
            notice = wait_for(lambda: os.path.exists(notice_path) and open(
                notice_path).read(), "the notice file")

            ckpt_path = pk.relay.ckpt_path(relay_dir, pods["w0"])
            os.makedirs(os.path.dirname(ckpt_path), exist_ok=True)
            with open(ckpt_path + ".tmp", "w") as f:
                json.dump(CKPT, f)
            os.replace(ckpt_path + ".tmp", ckpt_path)

            def mirrored():
                ann = fake.state.get("pods", "default", "w0")["metadata"].get(
                    "annotations") or {}
                return ann.get(pk.const.ANNOTATION_CKPT_STATE)

            ckpt_state = wait_for(mirrored, "the ckpt-state annotation")
            beat = wait_for(lambda: (fake.state.get("nodes", "", "na-node")[
                "metadata"].get("annotations") or {}).get(
                    pk.const.ANNOTATION_AGENT_HEARTBEAT), "a heartbeat")
            node = pk.kube.node_from_k8s(fake.state.get("nodes", "",
                                                        "na-node"))
            elsewhere = os.path.exists(pk.relay.preempt_path(
                relay_dir, pods["elsewhere"]))
            fake.state.delete("pods", "default", "w0")
            wait_for(lambda: not os.path.exists(notice_path),
                     "the relay files removed")
        finally:
            agent.stop()
    return {"notice": notice,
            "notice_file": os.path.relpath(notice_path, relay_dir).replace(
                pods["w0"].metadata.uid, "<uid>"),
            "ckpt_state": ckpt_state,
            "heartbeat_age": (dt.datetime.now(dt.timezone.utc)
                              - dt.datetime.fromisoformat(beat)
                              ).total_seconds(),
            "node_chips": node.spec.chips,
            "node_heartbeat": node.status.last_heartbeat is not None,
            "elsewhere_relayed": elsewhere}


@pytest.fixture(scope="module")
def arcs(tmp_path_factory):
    return {name: relay_arc(pk, tmp_path_factory.mktemp(name))
            for name, pk in PK.items()}


def test_notice_reaches_the_same_file(arcs):
    assert arcs["torch"]["notice"] == arcs["jax"]["notice"] == NOTICE
    assert arcs["torch"]["notice_file"] == arcs["jax"]["notice_file"]


def test_checkpoint_file_mirrored_into_the_same_annotation(arcs):
    assert arcs["torch"]["ckpt_state"] == arcs["jax"]["ckpt_state"]
    assert json.loads(arcs["torch"]["ckpt_state"]) == CKPT


def test_heartbeat_lands_on_the_node(arcs):
    for arc in arcs.values():
        assert 0 <= arc["heartbeat_age"] < 10
        assert arc["node_heartbeat"]
    # 8 allocatable nvidia.com/gpu on the port's node, 8 google.com/tpu
    # chips on JAX's: the same Node.spec.chips.
    assert arcs["torch"]["node_chips"] == arcs["jax"]["node_chips"] == 8


def test_pods_of_other_nodes_are_not_relayed(arcs):
    assert not arcs["torch"]["elsewhere_relayed"]
    assert not arcs["jax"]["elsewhere_relayed"]


def test_agent_needs_its_node_name(tmp_path):
    client = tkube.KubeClient(tkube.KubeConfig(server="http://127.0.0.1:1"))
    with pytest.raises(ValueError):
        tagent.KubeNodeAgent(client, "", str(tmp_path))
