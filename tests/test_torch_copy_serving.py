"""Copy of ``tests/test_serving.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Serving plane: tenant QoS lanes, continuous batching, SLO metrics,
spool claim semantics, control-plane wiring — and the e2e acceptance
arc: synthetic QPS through a 2-replica serving gang survives a slice
drain mid-traffic with ZERO dropped requests (in-flight sequences
re-queue through the save-before-evict barrier and complete on the
rebound replicas). A control test pins flag-off parity: without
--enable-serving the serving role is inert.
"""

import json
import os
import sys
import time

import pytest

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    CheckpointPolicy,
    Container,
    HealthPolicy,
    JobConditionType,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
    ReplicaSpec,
    RestartPolicy,
    ServingPolicy,
    TPUJob,
    TPUJobSpec,
    TPUSliceSpec,
)
from tf_operator_tpu_torch.api.validation import ValidationError, validate_job
from tf_operator_tpu_torch.controller.serving import ServingManager
from tf_operator_tpu_torch.runtime import metrics, store as store_mod
from tf_operator_tpu_torch.runtime.store import Store
from tf_operator_tpu_torch.serve.batcher import ContinuousBatcher, FakeRunner
from tf_operator_tpu_torch.serve.engine import ServingEngine
from tf_operator_tpu_torch.serve.queue import (
    Request,
    RequestQueue,
    parse_tenant_weights,
)
from tf_operator_tpu_torch.serve.worker import Spool

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "default"


def wait_for(predicate, timeout=30.0, interval=0.05, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


# ---------------------------------------------------------------------------
# RequestQueue: per-tenant QoS lanes
# ---------------------------------------------------------------------------

class TestRequestQueue:
    def test_fifo_single_tenant(self):
        q = RequestQueue(max_depth=8)
        for i in range(3):
            assert q.submit(Request(id=f"r{i}", tenant="t"))
        assert [q.pop().id for _ in range(3)] == ["r0", "r1", "r2"]
        assert q.pop() is None

    def test_weighted_fair_share(self):
        # 3:1 weights -> a full DRR cycle serves 3 of a, 1 of b.
        q = RequestQueue(max_depth=32, tenant_weights={"a": 3, "b": 1})
        for i in range(8):
            q.submit(Request(id=f"a{i}", tenant="a"))
            q.submit(Request(id=f"b{i}", tenant="b"))
        popped = [q.pop().id for _ in range(8)]
        assert popped == ["a0", "a1", "a2", "b0", "a3", "a4", "a5", "b1"]

    def test_light_tenant_never_starved(self):
        q = RequestQueue(max_depth=64, tenant_weights={"heavy": 8})
        for i in range(30):
            q.submit(Request(id=f"h{i}", tenant="heavy"))
        q.submit(Request(id="light", tenant="quiet"))
        popped = [q.pop().id for _ in range(10)]
        assert "light" in popped

    def test_max_depth_rejects_with_outcome(self):
        before = metrics.serving_requests_total.value(outcome="rejected")
        q = RequestQueue(max_depth=2)
        assert q.submit(Request(id="a"))
        assert q.submit(Request(id="b"))
        rejected = Request(id="c")
        assert not q.submit(rejected)
        assert rejected.outcome == "rejected"
        assert metrics.serving_requests_total.value(
            outcome="rejected") == before + 1

    def test_requeue_front_resets_progress(self):
        q = RequestQueue(max_depth=8)
        q.submit(Request(id="r0", tenant="t"))
        drained = Request(id="r1", tenant="t", output=[1, 2],
                          first_token_at=1.0)
        q.requeue_front(drained)
        head = q.pop()
        assert head.id == "r1"
        assert head.output == [] and head.first_token_at is None

    def test_queue_depth_gauge_tracks_lane(self):
        q = RequestQueue(max_depth=8)
        q.submit(Request(id="x", tenant="gaugetest"))
        assert metrics.serving_queue_depth.value(tenant="gaugetest") == 1
        q.pop()
        assert metrics.serving_queue_depth.value(tenant="gaugetest") == 0

    def test_parse_tenant_weights(self):
        assert parse_tenant_weights("a=3,b=1") == {"a": 3, "b": 1}
        assert parse_tenant_weights("") == {}
        assert parse_tenant_weights("bad,x=2,y=zero") == {"x": 2}
        assert parse_tenant_weights("z=0") == {"z": 1}  # floored

    def test_remove_tenant_prunes_gauge_series(self):
        """Tenant-lane GC (the PR-9 job-GC cardinality rule applied to
        tenants): removing a lane must delete its serving_queue_depth
        series from the scrape, not leave a forever-0 ghost."""
        q = RequestQueue(max_depth=8)
        q.submit(Request(id="x", tenant="ghost-tenant"))
        assert 'tenant="ghost-tenant"' in metrics.REGISTRY.render_text()
        waiting = q.remove_tenant("ghost-tenant")
        assert [r.id for r in waiting] == ["x"]
        assert 'tenant="ghost-tenant"' not in metrics.REGISTRY.render_text()
        # Re-submission after removal recreates the lane cleanly.
        assert q.submit(Request(id="y", tenant="ghost-tenant"))
        assert metrics.serving_queue_depth.value(tenant="ghost-tenant") == 1
        q.remove_tenant("ghost-tenant")


# ---------------------------------------------------------------------------
# ContinuousBatcher + ServingEngine
# ---------------------------------------------------------------------------

class TestContinuousBatching:
    def _engine(self, slots=2, max_depth=32, weights=None):
        queue = RequestQueue(max_depth=max_depth, tenant_weights=weights)
        return ServingEngine(queue, ContinuousBatcher(
            FakeRunner(max_slots=slots))), queue

    def test_all_requests_complete_to_budget(self):
        engine, queue = self._engine(slots=2)
        for i in range(5):
            queue.submit(Request(id=f"r{i}", prompt=[i], max_new_tokens=4))
        done = engine.run_until_idle()
        assert sorted(r.id for r in done) == [f"r{i}" for i in range(5)]
        assert all(len(r.output) == 4 for r in done)
        assert all(r.outcome == "completed" for r in done)
        assert engine.completed_total == 5
        assert engine.tokens_total == 20

    def test_outputs_deterministic_per_prompt(self):
        # Same prompt through different slot schedules -> same tokens
        # (slot state is per-sequence, never leaked across seats).
        engine1, q1 = self._engine(slots=1)
        engine3, q3 = self._engine(slots=3)
        for q in (q1, q3):
            for i in range(4):
                q.submit(Request(id=f"r{i}", prompt=[7, i],
                                 max_new_tokens=5))
        by_id_1 = {r.id: r.output for r in engine1.run_until_idle()}
        by_id_3 = {r.id: r.output for r in engine3.run_until_idle()}
        assert by_id_1 == by_id_3

    def test_continuous_admission_mid_decode(self):
        # A sequence finishing frees its slot for the next queued
        # request WITHOUT waiting for the whole batch (the continuous
        # part of continuous batching).
        engine, queue = self._engine(slots=1)
        queue.submit(Request(id="short", prompt=[1], max_new_tokens=1))
        queue.submit(Request(id="long", prompt=[2], max_new_tokens=3))
        first = engine.step()  # admits 'short', which completes at prefill
        assert [r.id for r in first] == ["short"]
        done = engine.run_until_idle()
        assert [r.id for r in done] == ["long"]

    def test_ttft_observed_on_completion(self):
        before = metrics.serving_ttft_seconds.count_value()
        engine, queue = self._engine()
        queue.submit(Request(id="r", prompt=[1], max_new_tokens=2))
        engine.run_until_idle()
        assert metrics.serving_ttft_seconds.count_value() == before + 1

    def test_drain_returns_queued_and_in_flight(self):
        engine, queue = self._engine(slots=2)
        for i in range(5):
            queue.submit(Request(id=f"r{i}", prompt=[i],
                                 max_new_tokens=50))
        engine.step()  # seats 2, leaves 3 queued
        assert engine.batcher.active == 2
        before = metrics.serving_requests_total.value(outcome="requeued")
        drained = engine.drain()
        assert sorted(r.id for r in drained) == [f"r{i}" for i in range(5)]
        assert all(r.outcome == "requeued" and r.output == []
                   for r in drained)
        assert engine.idle
        assert metrics.serving_requests_total.value(
            outcome="requeued") == before + 5

    def test_fairness_flows_through_to_slots(self):
        # Heavy tenant floods; light tenant's single request still gets
        # a slot within one DRR cycle.
        engine, queue = self._engine(slots=1,
                                     weights={"heavy": 4, "light": 1})
        for i in range(12):
            queue.submit(Request(id=f"h{i}", tenant="heavy", prompt=[i],
                                 max_new_tokens=1))
        queue.submit(Request(id="l0", tenant="light", prompt=[0],
                             max_new_tokens=1))
        order = []
        while not engine.idle:
            order.extend(r.id for r in engine.step())
        assert order.index("l0") <= 4


# ---------------------------------------------------------------------------
# Spool: atomic claim / requeue / finish
# ---------------------------------------------------------------------------

class TestSpool:
    def _write_request(self, root, rid, tenant="t", prompt=(1, 2)):
        os.makedirs(os.path.join(root, "pending"), exist_ok=True)
        path = os.path.join(root, "pending", f"{rid}.json")
        with open(path + ".tmp", "w") as f:
            json.dump({"id": rid, "tenant": tenant,
                       "prompt": list(prompt), "maxNewTokens": 3}, f)
        os.replace(path + ".tmp", path)

    def test_claim_is_exclusive_across_replicas(self, tmp_path):
        root = str(tmp_path)
        self._write_request(root, "only")
        a, b = Spool(root, "pod-a"), Spool(root, "pod-b")
        got_a, got_b = a.claim_one(), b.claim_one()
        assert (got_a is None) != (got_b is None)  # exactly one winner
        winner = got_a or got_b
        assert winner.id == "only" and winner.prompt == [1, 2]

    def test_requeue_then_other_replica_claims(self, tmp_path):
        root = str(tmp_path)
        self._write_request(root, "r0")
        a, b = Spool(root, "pod-a"), Spool(root, "pod-b")
        assert a.claim_one().id == "r0"
        a.requeue_id("r0")
        assert b.claim_one().id == "r0"

    def test_finish_writes_response_and_clears_claim(self, tmp_path):
        root = str(tmp_path)
        self._write_request(root, "r0")
        spool = Spool(root, "pod-a")
        request = spool.claim_one()
        request.output = [5, 6, 7]
        spool.finish(request)
        with open(os.path.join(root, "done", "r0.json")) as f:
            payload = json.load(f)
        assert payload["tokens"] == [5, 6, 7]
        assert payload["servedBy"] == "pod-a"
        assert spool.claimed_empty() and spool.pending_empty()

    def test_unparseable_request_is_requeued_not_served(self, tmp_path):
        root = str(tmp_path)
        os.makedirs(os.path.join(root, "pending"), exist_ok=True)
        with open(os.path.join(root, "pending", "bad.json"), "w") as f:
            f.write("{not json")
        spool = Spool(root, "pod-a")
        assert spool.claim_one() is None
        assert os.path.exists(os.path.join(root, "pending", "bad.json"))

    def test_concurrent_claim_exactly_one_winner(self, tmp_path):
        """Two replicas racing claim_one on REAL threads: the atomic
        pending->claimed rename admits exactly one winner per request
        (the single-threaded exclusivity test above can't catch a
        read-then-rename TOCTOU; this hammers it)."""
        import threading

        root = str(tmp_path)
        rounds = 25
        for i in range(rounds):
            self._write_request(root, f"r{i:03d}")
        spools = (Spool(root, "pod-a"), Spool(root, "pod-b"))
        wins = ([], [])
        barrier = threading.Barrier(2)

        def racer(idx):
            barrier.wait()
            while True:
                got = spools[idx].claim_one()
                if got is None:
                    if spools[idx].pending_empty():
                        return
                    continue
                wins[idx].append(got.id)

        threads = [threading.Thread(target=racer, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        claimed = wins[0] + wins[1]
        assert len(claimed) == rounds  # nothing lost...
        assert len(set(claimed)) == rounds  # ...and nothing double-won


# ---------------------------------------------------------------------------
# ServingPolicy validation + ServingManager env rendering
# ---------------------------------------------------------------------------

def serving_job(name="sj", replicas=2, policy=None, accelerator="h100-16",
                rtype="serving", command=None) -> TPUJob:
    job = TPUJob(metadata=ObjectMeta(name=name, namespace=NS))
    job.spec = TPUJobSpec(
        replica_specs={rtype: ReplicaSpec(
            replicas=replicas, restart_policy=RestartPolicy.NEVER,
            template=PodTemplateSpec(spec=PodSpec(containers=[Container(
                name=constants.DEFAULT_CONTAINER_NAME,
                command=command or [sys.executable, "-m",
                                    "tf_operator_tpu_torch.serve.worker"],
            )])))},
        slice=TPUSliceSpec(accelerator=accelerator))
    job.spec.run_policy.serving_policy = policy
    return job


class TestServingPolicyValidation:
    def test_serving_role_is_a_known_replica_type(self):
        validate_job(serving_job(policy=None))

    def test_enabled_policy_requires_spool(self):
        with pytest.raises(ValidationError, match="spoolDirectory"):
            validate_job(serving_job(policy=ServingPolicy(enabled=True)))

    def test_enabled_policy_requires_serving_replicas(self):
        job = serving_job(rtype="worker", policy=ServingPolicy(
            enabled=True, spool_directory="/tmp/s"))
        with pytest.raises(ValidationError, match="serving"):
            validate_job(job)

    def test_bounds(self):
        for kw, msg in (
                (dict(max_batch_slots=0), "maxBatchSlots"),
                (dict(max_queue_depth=0), "maxQueueDepth"),
                (dict(max_tokens_per_request=0), "maxTokensPerRequest"),
                (dict(ttft_p99_slo_seconds=0.0), "ttftP99SloSeconds"),
                (dict(tokens_per_second_slo=-1.0), "tokensPerSecondSlo"),
                (dict(target_queue_depth_per_slice=0),
                 "targetQueueDepthPerSlice"),
                (dict(scale_down_cooldown_seconds=-1.0),
                 "scaleDownCooldownSeconds")):
            policy = ServingPolicy(enabled=True, spool_directory="/s", **kw)
            with pytest.raises(ValidationError, match=msg):
                validate_job(serving_job(policy=policy))

    def test_zero_cooldown_is_legal(self):
        # scaleDownCooldownSeconds=0 = no hysteresis (deterministic
        # tests); only negatives are rejected.
        validate_job(serving_job(policy=ServingPolicy(
            enabled=True, spool_directory="/s",
            target_queue_depth_per_slice=4,
            scale_down_cooldown_seconds=0.0)))

    def test_disabled_policy_with_knobs_is_carried(self):
        validate_job(serving_job(policy=ServingPolicy(
            enabled=False, max_batch_slots=4)))


class TestServingManager:
    def test_env_rendering_for_serving_role(self):
        store = Store()
        manager = ServingManager(store)
        job = serving_job(policy=ServingPolicy(
            enabled=True, spool_directory="/spool", max_batch_slots=3,
            max_queue_depth=17, max_tokens_per_request=9))
        env = manager.bootstrap_env(job, "serving")
        assert env[constants.ENV_SERVE_SPOOL] == "/spool"
        assert env[constants.ENV_SERVE_SLOTS] == "3"
        assert env[constants.ENV_SERVE_MAX_QUEUE] == "17"
        assert env[constants.ENV_SERVE_MAX_TOKENS] == "9"
        assert constants.ENV_SERVE_TENANT_WEIGHTS not in env

    def test_no_env_for_other_roles_or_disabled(self):
        manager = ServingManager(Store())
        enabled = serving_job(policy=ServingPolicy(
            enabled=True, spool_directory="/spool"))
        assert manager.bootstrap_env(enabled, "worker") == {}
        assert manager.bootstrap_env(serving_job(policy=None),
                                     "serving") == {}

    def test_tenant_weights_follow_cluster_queue_nominals(self):
        from tf_operator_tpu_torch.api.types import (
            ClusterQueue,
            ClusterQueueSpec,
            TenantQueue,
            TenantQueueSpec,
        )

        store = Store()
        store.create(store_mod.CLUSTERQUEUES, ClusterQueue(
            metadata=ObjectMeta(name="gold", namespace=""),
            spec=ClusterQueueSpec(nominal_chips=8)))
        store.create(store_mod.TENANTQUEUES, TenantQueue(
            metadata=ObjectMeta(name="team-a", namespace=NS),
            spec=TenantQueueSpec(cluster_queue="gold")))
        store.create(store_mod.TENANTQUEUES, TenantQueue(
            metadata=ObjectMeta(name="team-b", namespace=NS),
            spec=TenantQueueSpec(cluster_queue="missing")))
        manager = ServingManager(store)
        assert manager.tenant_weights(NS) == {"team-a": 8, "team-b": 1}
        job = serving_job(policy=ServingPolicy(
            enabled=True, spool_directory="/spool"))
        env = manager.bootstrap_env(job, "serving")
        assert env[constants.ENV_SERVE_TENANT_WEIGHTS] == \
            "team-a=8,team-b=1"


# ---------------------------------------------------------------------------
# E2E: serving gang under the local operator
# ---------------------------------------------------------------------------

def _node(name, conditions):
    from tf_operator_tpu_torch.api.types import Node, NodeSpec, NodeStatus

    return Node(metadata=ObjectMeta(name=name, namespace=""),
                spec=NodeSpec(chips=8),
                status=NodeStatus(phase="Ready",
                                  conditions=dict(conditions)))


def e2e_serving_job(name, spool, barrier_timeout=20.0) -> TPUJob:
    job = serving_job(name=name, policy=ServingPolicy(
        enabled=True, spool_directory=spool, max_batch_slots=2,
        max_queue_depth=8, max_tokens_per_request=8))
    job.spec.run_policy.clean_pod_policy = "None"
    job.spec.run_policy.health_policy = HealthPolicy(enabled=True)
    # The drain barrier rides checkpoint coordination: the serving
    # worker's "save" is its re-spool, acked through the same record
    # channel (docs/serving.md "Drain mid-traffic").
    job.spec.run_policy.checkpoint_policy = CheckpointPolicy(
        enabled=True, directory=spool, interval_steps=100000,
        barrier_timeout_seconds=barrier_timeout)
    return job


def write_request(spool, rid, tenant, prompt, max_new_tokens=4):
    path = os.path.join(spool, "pending", f"{rid}.json")
    with open(path + ".tmp", "w") as f:
        json.dump({"id": rid, "tenant": tenant, "prompt": prompt,
                   "maxNewTokens": max_new_tokens}, f)
    os.replace(path + ".tmp", path)


def done_ids(spool):
    done = os.path.join(spool, "done")
    if not os.path.isdir(done):
        return set()
    return {n[:-len(".json")] for n in os.listdir(done)
            if n.endswith(".json")}


@pytest.mark.e2e
class TestServingE2E:
    def _operator(self, **kw):
        from tf_operator_tpu_torch.operator import Operator

        op = Operator.local(workdir=REPO_ROOT,
                            enable_gang_scheduling=True,
                            total_chips=16,
                            enable_slice_health=True, **kw)
        op.start(threadiness=2)
        return op

    def _inject_maintenance(self, store, job_name):
        for pod in store.list(store_mod.PODS,
                              selector={constants.LABEL_JOB_NAME:
                                        job_name}):
            fresh = pod.deepcopy()
            fresh.spec.node_name = "n-maint"
            store.update(store_mod.PODS, fresh)
        store.create(store_mod.NODES, _node(
            "n-maint", conditions={"Ready": "True",
                                   "MaintenancePending": "True"}))

    def test_drain_mid_traffic_zero_dropped_requests(self, tmp_path):
        """The ISSUE acceptance arc: synthetic QPS through a 2-replica
        serving gang; a slice drain mid-traffic re-queues in-flight
        sequences through the save-before-evict barrier; the rebound
        replicas complete every request — zero dropped."""
        from tf_operator_tpu_torch.sdk import TPUJobClient

        spool = str(tmp_path / "spool")
        os.makedirs(os.path.join(spool, "pending"))
        op = self._operator(enable_ckpt_coordination=True,
                            enable_serving=True)
        try:
            client = TPUJobClient(op.store)
            client.create(e2e_serving_job("servejob", spool))
            client.wait_for_condition("servejob",
                                      JobConditionType.RUNNING,
                                      timeout=30)
            total = 24
            for i in range(total):
                write_request(spool, f"req{i:03d}",
                              "team-a" if i % 2 else "team-b",
                              [i, i + 1, i + 2])
            # Mid-traffic: some responses landed, more still pending.
            wait_for(lambda: len(done_ids(spool)) >= 4,
                     message="first responses")
            assert len(done_ids(spool)) < total
            self._inject_maintenance(op.store, "servejob")
            # Every request completes across the drain (re-queued
            # sequences finish on the rebound replicas).
            wait_for(lambda: len(done_ids(spool)) >= total, timeout=60,
                     message="all responses after drain")
            assert done_ids(spool) == {f"req{i:03d}"
                                       for i in range(total)}
            # The drain rode the barrier (acked, not timed out), and
            # the workers logged the re-queue + resume arc.
            open(os.path.join(spool, ".close"), "w").close()
            job = client.wait_for_job("servejob", timeout=60)
            assert any(c.type == JobConditionType.SUCCEEDED
                       and c.status == "True"
                       for c in job.status.conditions)
            barrier = [c for c in job.status.conditions
                       if c.type == JobConditionType.CHECKPOINT_BARRIER]
            assert barrier and barrier[0].status == "False"
            assert barrier[0].reason == "CheckpointBarrierSaved"
            # Only the rebound incarnations' logs survive (the data
            # plane deletes a pod's log with the pod): they prove the
            # restart-with-identity arc saw the drained fleet state.
            logs = client.get_job_logs("servejob")
            assert any("resumed after drain" in text
                       for text in logs.values())
            # Zero dropped AND zero lost to the spool: nothing pending
            # or claimed anywhere.
            assert not any(n.endswith(".json") for n in
                           os.listdir(os.path.join(spool, "pending")))
            for sub in os.listdir(os.path.join(spool, "claimed")):
                assert not os.listdir(os.path.join(spool, "claimed", sub))
        finally:
            op.stop()

    def test_tenant_fairness_under_load(self, tmp_path):
        """A flooding tenant must not starve a light one: the light
        tenant's requests complete well before the heavy backlog."""
        from tf_operator_tpu_torch.sdk import TPUJobClient

        spool = str(tmp_path / "spool")
        os.makedirs(os.path.join(spool, "pending"))
        op = self._operator(enable_serving=True)
        try:
            client = TPUJobClient(op.store)
            job = e2e_serving_job("fairjob", spool)
            job.spec.run_policy.checkpoint_policy = None
            client.create(job)
            client.wait_for_condition("fairjob",
                                      JobConditionType.RUNNING,
                                      timeout=30)
            for i in range(30):
                write_request(spool, f"heavy{i:03d}", "heavy", [i])
            write_request(spool, "light000", "light", [7])
            wait_for(lambda: "light000" in done_ids(spool), timeout=30,
                     message="light tenant served")
            assert len(done_ids(spool)) < 31  # heavy backlog remains
            open(os.path.join(spool, ".close"), "w").close()
            job = client.wait_for_job("fairjob", timeout=60)
            assert any(c.type == JobConditionType.SUCCEEDED
                       and c.status == "True"
                       for c in job.status.conditions)
        finally:
            op.stop()

    def test_serving_role_inert_without_flag(self, tmp_path):
        """Flag-off parity control: without --enable-serving a
        serving-role job is reconciled like any other replica type —
        no TPUJOB_SERVE_* env is rendered, no serving subsystem exists
        on the operator, and the pods just run their command."""
        from tf_operator_tpu_torch.sdk import TPUJobClient

        op = self._operator()
        assert op.serving is None
        try:
            client = TPUJobClient(op.store)
            job = serving_job(
                name="inertjob",
                policy=ServingPolicy(enabled=True,
                                     spool_directory=str(tmp_path)),
                command=[sys.executable, "-m",
                         "tf_operator_tpu_torch.runtime.worker_stub",
                         "--exit-after", "60"])
            job.spec.run_policy.clean_pod_policy = "None"
            client.create(job)
            client.wait_for_condition("inertjob",
                                      JobConditionType.RUNNING,
                                      timeout=30)
            for pod in op.store.list(
                    store_mod.PODS,
                    selector={constants.LABEL_JOB_NAME: "inertjob"}):
                env = pod.spec.containers[0].env
                assert not any(k.startswith("TPUJOB_SERVE_")
                               for k in env), env
                # Serving replicas still hold chips (role semantics,
                # not flag-gated): gang admission stays correct.
                assert pod.spec.containers[0].resources.get(
                    constants.RESOURCE_GPU) == "8"
        finally:
            op.stop()


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
