"""Leader failover on the port's kube backend, against the port's fake
API server (``runtime/kube_fake.py``), held to the JAX package's
``tests/test_kube.py`` ``test_lease_cas_and_failover`` and
``TestLeaderFailoverDuringPreemption``.

Each scenario is written once against a package and runs through both,
each package against its own fake. The eviction scenario adds a
bystander job on a third node and checks, beyond what the JAX test
asserts: no node's GPUs double-booked at any sampled instant, and every
pod that survived the failover (the bystander's, and any of the
preemptor's made before it) keeps the uid and the bootstrap hash it had
when the leader died. The JAX package evicts the bystander there (its
SliceGroups live in the leader's memory, and the standby rebuilt the
bystander's as Pending beside a running pod, which reads as
mid-eviction); the port adopts it (``ROADMAP.md`` C). The two packages
are compared on what the JAX test asserts.

The waits are 30-60 s where the JAX test has 10-40 s: the suite runs in
six worker processes.
"""

import threading
import time
import types

import pytest

from tf_operator_tpu.api import constants as jconst
from tf_operator_tpu.api import types as jtypes
from tf_operator_tpu.runtime import kube as jkube
from tf_operator_tpu.runtime import kube_fake as jfake
from tf_operator_tpu.runtime import leaderelection as jle
from tf_operator_tpu.runtime import store as jstore
from tf_operator_tpu_torch.api import constants as tconst
from tf_operator_tpu_torch.api import types as ttypes
from tf_operator_tpu_torch.runtime import kube as tkube
from tf_operator_tpu_torch.runtime import kube_fake as tfake
from tf_operator_tpu_torch.runtime import leaderelection as tle
from tf_operator_tpu_torch.runtime import store as tstore

pytestmark = pytest.mark.control_plane

PK = {
    "jax": types.SimpleNamespace(
        name="jax", kube=jkube, fake=jfake, store=jstore, types=jtypes,
        const=jconst, le=jle, device=jconst.RESOURCE_TPU,
        accelerator=lambda n: f"v5e-{n}", domain_kw="ici_domain"),
    "port": types.SimpleNamespace(
        name="port", kube=tkube, fake=tfake, store=tstore, types=ttypes,
        const=tconst, le=tle, device=tconst.RESOURCE_GPU,
        accelerator=lambda n: f"h100-{n}", domain_kw="nvlink_domain"),
}


def wait_for(cond, timeout=30.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = cond()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def both(scenario):
    out = {name: scenario(pk) for name, pk in PK.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


def make_job(pk, name, workers, accelerator, priority):
    """A TPUJob CR body in K8s wire form."""
    t, c = pk.types, pk.const
    job = t.TPUJob(metadata=t.ObjectMeta(name=name, namespace="default"))
    job.spec = t.TPUJobSpec(replica_specs={
        "worker": t.ReplicaSpec(
            replicas=workers,
            template=t.PodTemplateSpec(spec=t.PodSpec(containers=[
                t.Container(name=c.DEFAULT_CONTAINER_NAME,
                            image="tpu-worker:latest",
                            command=["python", "-m", "train"])])),
            restart_policy=t.RestartPolicy.NEVER)})
    body = pk.kube.tpujob_to_k8s(job)
    body["spec"]["slice"] = {"accelerator": accelerator}
    body["spec"]["runPolicy"] = {"schedulingPolicy": {
        "priorityClass": priority}}
    return body


def _lease_failover(pk):
    with pk.fake.FakeKubeApiServer() as fake:
        client = pk.kube.KubeClient(pk.kube.KubeConfig(server=fake.url))
        # Whole-second durations: K8s LeaseSpec carries an integer.
        a, b = (pk.le.LeaderElector(pk.kube.KubeLeaseStore(client),
                                    identity=i, lease_duration=2.0,
                                    renew_deadline=0.5, retry_period=0.1)
                for i in ("a", "b"))
        a.start()
        try:
            a_leads = a.wait_until_leading(timeout=15)
            b.start()
            b_while_held = b.wait_until_leading(timeout=0.6)
            a.stop()      # releases: b takes over
            b_after = b.wait_until_leading(timeout=15)
            raw = fake.state.get("leases", "default",
                                 pk.le.DEFAULT_LOCK_NAME)
            return {"a_leads": a_leads, "b_while_held": b_while_held,
                    "b_after_release": b_after,
                    "holder": raw["spec"]["holderIdentity"]}
        finally:
            a.stop()
            b.stop()


def test_lease_cas_and_failover():
    assert both(_lease_failover) == {"a_leads": True, "b_while_held": False,
                                     "b_after_release": True, "holder": "b"}


def _pods(fake, prefix, n):
    return [fake.state.objects["pods"].get(("default", f"{prefix}-worker-{i}"))
            for i in range(n)]


def _booked(pk, fake):
    """GPUs (TPU chips for JAX) bound a node, over live pods."""
    usage = {}
    for pod in list(fake.state.objects["pods"].values()):
        node = (pod.get("spec") or {}).get("nodeName")
        phase = (pod.get("status") or {}).get("phase", "Pending")
        if not node or phase in ("Succeeded", "Failed"):
            continue
        limits = ((pod["spec"]["containers"][0].get("resources")
                   or {}).get("limits") or {})
        usage[node] = usage.get(node, 0) + int(limits.get(pk.device, 0))
    return usage


def _failover_mid_eviction(pk, bystander):
    """Two Lease-elected replicas; the leader dies right after preemption
    starts (the victim's group flipped Pending, deletes in flight). The
    standby finishes the eviction from the store's state alone. With
    ``bystander``, a third node runs a high-priority job throughout."""
    hash_key = pk.const.ANNOTATION_BOOTSTRAP_HASH
    with pk.fake.FakeKubeApiServer() as fake:
        client = pk.kube.KubeClient(pk.kube.KubeConfig(server=fake.url))
        fake.state.latency_seconds = 0.005  # widen the in-flight window
        nodes = [f"n{i}" for i in range(3 if bystander else 2)]
        for node in nodes:
            fake.state.add_node(node, chips=8, **{pk.domain_kw: "dom-a"})
        ops = [pk.kube.KubeOperator(
            pk.kube.KubeClient(pk.kube.KubeConfig(server=fake.url)),
            post_events=False, enable_gang_scheduling=True,
            gang_preemption=True,
            gang_priority_classes={"prod": 100, "batch": 10})
            for _ in range(2)]
        electors = [pk.le.LeaderElector(
            pk.kube.KubeLeaseStore(ops[i].client), identity=f"op-{i}",
            lease_duration=2.0, renew_deadline=0.8, retry_period=0.1,
            on_started_leading=(lambda op=ops[i]: op.start(
                threadiness=1, sync_timeout=15)))
            for i in range(2)]
        peak = {}
        sampling = threading.Event()

        def sample():
            while not sampling.wait(0.02):
                for node, gpus in _booked(pk, fake).items():
                    peak[node] = max(peak.get(node, 0), gpus)

        sampler = threading.Thread(target=sample, daemon=True)
        try:
            electors[0].start()
            assert electors[0].wait_until_leading(timeout=15)
            electors[1].start()
            sampler.start()
            if bystander:   # it must ride out the failover untouched
                client.create(pk.store.TPUJOBS, "default", make_job(
                    pk, "bys", 1, pk.accelerator(8), "prod"))
                wait_for(lambda: all(p and p["spec"].get("nodeName")
                                     for p in _pods(fake, "bys", 1)),
                         msg="bystander bound")
                fake.state.set_pod_phase("default", "bys-worker-0",
                                         "Running")
            client.create(pk.store.TPUJOBS, "default", make_job(
                pk, "vic", 2, pk.accelerator(16), "batch"))
            wait_for(lambda: all(p and p["spec"].get("nodeName")
                                 for p in _pods(fake, "vic", 2)),
                     msg="victim bound")
            fake.state.set_pod_phase("default", "vic-worker-0", "Running")
            vic_uids = {p["metadata"]["uid"] for p in _pods(fake, "vic", 2)}
            client.create(pk.store.TPUJOBS, "default", make_job(
                pk, "pre", 2, pk.accelerator(16), "prod"))

            def preemption_started():
                sg = ops[0].store.try_get(pk.store.SLICEGROUPS, "default",
                                          "vic")
                return sg is not None and sg.status.phase == "Pending"

            wait_for(preemption_started, msg="preemption decided")
            # The leader dies: no lease release, no more reconciling.
            electors[0]._stop.set()
            electors[0]._thread.join(timeout=5)
            ops[0].stop()
            survivors = {
                name: (p["metadata"]["uid"],
                       (p["metadata"].get("annotations") or {}).get(hash_key))
                for (ns, name), p in list(fake.state.objects["pods"].items())
                if not name.startswith("vic-")}
            wait_for(lambda: electors[1].is_leader,
                     msg="standby acquired the lease")

            def converged():
                if any(p and p["metadata"]["uid"] in vic_uids
                       for p in _pods(fake, "vic", 2)):
                    return False  # an old victim pod still alive
                return all(p and p["spec"].get("nodeName")
                           for p in _pods(fake, "pre", 2))

            wait_for(converged, timeout=60,
                     msg="standby finished eviction + placed preemptor")
            time.sleep(0.2)   # a few more samples past convergence
            after = {name: (p["metadata"]["uid"],
                            (p["metadata"].get("annotations") or {}).get(
                                hash_key))
                     for name, p in (((n, fake.state.objects["pods"].get(
                         ("default", n))) for n in survivors))
                     if p is not None}
            victim_unbound = all(not p or not p["spec"].get("nodeName")
                                 for p in _pods(fake, "vic", 2))
            return {"final_within_capacity": all(
                        v <= 8 for v in _booked(pk, fake).values()),
                    "peak_within_capacity": all(v <= 8
                                                for v in peak.values()),
                    "nodes_sampled": sorted(peak) == nodes,
                    "preemptor_placed": True,
                    "victim_unbound": victim_unbound,
                    "bystander_survived": "bys-worker-0" in survivors,
                    "survivors_unchanged": after == survivors,
                    "hashed": all(h for _, h in survivors.values())}
        finally:
            sampling.set()
            fake.state.latency_seconds = 0.0
            for e in electors:
                e.stop()
            for op in ops:
                try:
                    op.stop()
                except Exception:
                    pass


def test_failover_mid_eviction_converges():
    """tests/test_kube.py's scenario through both packages: the victim
    evicted and unbound, the preemptor placed, no node over capacity."""
    out = {name: _failover_mid_eviction(pk, bystander=False)
           for name, pk in PK.items()}
    for name in PK:
        assert out[name]["final_within_capacity"], out
        assert out[name]["preemptor_placed"], out
        assert out[name]["victim_unbound"], out
    assert out["port"] == out["jax"], out


def test_failover_mid_eviction_leaves_a_running_bystander_alone():
    """The same failover beside a running high-priority job: the port's
    standby finishes the eviction, never books a node past its GPUs,
    and every pod that survived the kill keeps its uid and bootstrap
    hash."""
    port = _failover_mid_eviction(PK["port"], bystander=True)
    assert port["final_within_capacity"] and port["peak_within_capacity"]
    assert port["preemptor_placed"] and port["victim_unbound"]
    assert port["nodes_sampled"], port
    assert port["bystander_survived"] and port["hashed"], port
    assert port["survivors_unchanged"], (
        "a pod that survived the failover was recreated or re-hashed "
        f"by the standby: {port}")


def test_a_rebuilt_slice_group_adopts_its_running_gang():
    """The standby's first sync of a running job finds no SliceGroup (it
    lived in the dead leader's memory): the group is rebuilt admitted,
    and the admission pass leaves the job's pod alone."""
    from tf_operator_tpu_torch import testutil
    from tf_operator_tpu_torch.controller.gang import (
        PHASE_INQUEUE,
        PHASE_PENDING,
        SliceGangScheduler,
    )

    store = tstore.Store()
    gang = SliceGangScheduler(store, total_chips=16, preemption=True,
                              priority_classes={"prod": 100})
    running = store.create(tstore.TPUJOBS, testutil.new_tpujob(
        worker=1, name="running", accelerator="h100-8"))
    store.create(tstore.PODS, testutil.new_pod(
        running, "worker", 0, phase=ttypes.PodPhase.RUNNING))
    queued = store.create(tstore.TPUJOBS, testutil.new_tpujob(
        worker=1, name="queued", accelerator="h100-16"))
    for job in (running, queued):
        gang.sync_slice_group(job, job.spec.replica_specs)
    phases = {name: store.get(tstore.SLICEGROUPS, "default", name).status.phase
              for name in ("running", "queued")}
    assert phases == {"running": PHASE_INQUEUE, "queued": PHASE_PENDING}, (
        f"the running gang's rebuilt group is {phases['running']}")
    assert store.try_get(tstore.PODS, "default",
                         "running-worker-0") is not None, (
        "the admission pass evicted the running gang")


@pytest.mark.parametrize("case", ["recreated", "terminating"])
def test_a_rebuilt_slice_group_adopts_only_its_jobs_live_pods(case):
    """A group is adopted as admitted only for pods the job owns and that
    are not terminating. ``recreated``: the job is deleted and re-created
    at a larger size under its name while the old job's pod still runs
    out its grace; ``terminating``: the job's own pod is marked for
    deletion. Either way the new group stays Pending: the old pod holds
    half the budget, so admission must not let the larger gang in."""
    import datetime

    from tf_operator_tpu_torch import testutil
    from tf_operator_tpu_torch.controller.gang import (
        PHASE_PENDING,
        SliceGangScheduler,
    )

    store = tstore.Store()
    gang = SliceGangScheduler(store, total_chips=16, preemption=True,
                              priority_classes={"prod": 100})
    old = store.create(tstore.TPUJOBS, testutil.new_tpujob(
        worker=1, name="gang", accelerator="h100-8"))
    pod = testutil.new_pod(old, "worker", 0, phase=ttypes.PodPhase.RUNNING)
    if case == "terminating":
        pod.metadata.deletion_timestamp = datetime.datetime.now(
            datetime.timezone.utc)
    store.create(tstore.PODS, pod)
    job = old
    if case == "recreated":
        store.delete(tstore.TPUJOBS, "default", "gang")
        job = store.create(tstore.TPUJOBS, testutil.new_tpujob(
            worker=1, name="gang", accelerator="h100-16"))
        assert job.metadata.uid != old.metadata.uid
    gang.sync_slice_group(job, job.spec.replica_specs)
    phase = store.get(tstore.SLICEGROUPS, "default", "gang").status.phase
    assert phase == PHASE_PENDING, (
        f"the {case} job's group was adopted as {phase} without admission")
